"""Multi-process runtime on `torch.distributed` (counterpart of the JAX
package's `parallel/runtime.py`): process-group initialisation, the
primary-process check, the chain mesh over every process, small gathers and
primary-only metric writes, and a launcher that runs one rank per process.

Every process runs the same program. `init_runtime` joins the processes
into one process group, `global_mesh` gives the chain mesh over all of
them, and the collectives of `parallel/collectives.py` reduce a handful of
sums across it; chains never communicate.

Launch patterns:
  * torchrun (or any launcher that sets MASTER_ADDR, RANK and WORLD_SIZE):
    `init_runtime()` with no arguments joins through `env://`.
  * Explicit: pass coordinator_address / num_processes / process_id, or set
    LATTICE_MCMC_COORDINATOR, LATTICE_MCMC_NUM_PROCESSES and
    LATTICE_MCMC_PROCESS_ID (`run_ranks` does so for the processes it
    starts).
With neither, the call is single-process and sets up no group. A failed
initialisation raises.

Backend: NCCL when every rank has a CUDA card of its own (the local rank
r, torchrun's LOCAL_RANK or else the rank, takes card r mod the host's card
count), gloo on the CPU and when a host's ranks share a card (NCCL refuses
two ranks on one card). The ranks on a host are LOCAL_WORLD_SIZE (torchrun
and `run_ranks` set it); without it, one with a coordinator (the
LATTICE_MCMC_* launch runs one process a host) and all of them under
`env://`. Under gloo the reductions copy their few sums to the host.

Nothing is scattered from a primary (the JAX package's `put_global` has no
counterpart): every rank builds the lattice, the precomputation and its
chain range from seeds, and the Philox stream is keyed by global chain id
(`utils/prng.py`), so a rank draws exactly the numbers of its chains.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import (
    ChainMesh,
    all_gather,
    make_mesh,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device

_ENV_COORD = "LATTICE_MCMC_COORDINATOR"
_ENV_NPROC = "LATTICE_MCMC_NUM_PROCESSES"
_ENV_PID = "LATTICE_MCMC_PROCESS_ID"

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    """What `init_runtime` established."""

    distributed: bool
    process_index: int
    process_count: int
    n_local_devices: int
    n_global_devices: int
    device: torch.device
    backend: Optional[str] = None
    coordinator: Optional[str] = None


def _backend(device: torch.device, local_default: int) -> str:
    # ranks on this host: LOCAL_WORLD_SIZE, else local_default
    local = int(os.environ.get("LOCAL_WORLD_SIZE", local_default))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(device, rank: int) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def init_runtime(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device=None) -> RuntimeInfo:
    """Join the process group (idempotent) and pick this rank's device:
    `device` (None: the card; with no card that raises) or, on a host with
    several cards, card rank mod their count. The coordinator is a
    `tcp://host:port` or `file://path` address; a bare `host:port` means
    tcp. Without one (argument or LATTICE_MCMC_COORDINATOR), torchrun's
    MASTER_ADDR, RANK and WORLD_SIZE join through `env://`; without those
    the call is single-process."""
    if dist.is_initialized():
        return _info(_rank_device(device, dist.get_rank()), None)
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        dev = _rank_device(device, process_id)
        dist.init_process_group(_backend(dev, 1),
                                init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    elif all(env.get(k) for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        coordinator_address = "env://"
        dev = _rank_device(device, process_id)
        dist.init_process_group(_backend(dev, num_processes),
                                init_method="env://")
    else:
        dev = resolve_device(device)
    return _info(dev, coordinator_address)


def _info(dev: torch.device, coordinator) -> RuntimeInfo:
    up = dist.is_initialized()
    size = dist.get_world_size() if up else 1
    return RuntimeInfo(
        distributed=up and size > 1,
        process_index=dist.get_rank() if up else 0,
        process_count=size,
        n_local_devices=1,
        n_global_devices=size,
        device=dev,
        backend=dist.get_backend() if up else None,
        coordinator=coordinator)


def shutdown_runtime() -> None:
    """Leave the process group (a no-op without one), so that a later
    phase of the same process starts from no group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on rank 0, the only rank that writes metrics and artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(device=None) -> ChainMesh:
    """The chain mesh over every process of the group (`make_mesh`)."""
    return make_mesh(device)


def all_processes_array(x: torch.Tensor, mesh: Optional[ChainMesh] = None
                        ) -> np.ndarray:
    """Gather every rank's (C_local, ...) block along the chain axis into a
    full host copy on every rank (small results: diagnostics, digests'
    inputs, not a run's chains)."""
    mesh = mesh or make_mesh(x.device)
    return all_gather(x, mesh).cpu().numpy()


def write_metrics(path: str, obj) -> None:
    """JSON metric write on the primary only (every rank holds the same
    all-reduced diagnostics; one writes)."""
    if not is_primary():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)


def free_port() -> int:
    """A TCP port free on this host now (for a localhost coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, n_ranks: int, args: Sequence[str] = (),
              timeout: float = 600.0) -> List[dict]:
    """Run `python -m module` in n_ranks processes on this host, joined
    through a localhost coordinator (the LATTICE_MCMC_* variables, and
    LOCAL_WORLD_SIZE = n_ranks), each with `args` after them, and wait for
    all of them at most `timeout` seconds in all. When a rank fails or the
    time is up, every rank still running is killed and the call raises.
    Returns each rank's last standard-output line, parsed as JSON, in rank
    order."""
    coordinator = f"tcp://127.0.0.1:{free_port()}"
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        try:
            for rank in range(n_ranks):
                # one torch thread a rank: small per-row ops are much
                # slower on a shared pool
                env = dict(os.environ, **{_ENV_COORD: coordinator,
                                          _ENV_NPROC: str(n_ranks),
                                          _ENV_PID: str(rank),
                                          "LOCAL_WORLD_SIZE": str(n_ranks),
                                          "OMP_NUM_THREADS": "1"})
                outs.append(os.path.join(tmp, f"rank{rank}"))
                with open(outs[-1] + ".out", "w") as fo, \
                        open(outs[-1] + ".err", "w") as fe:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", module, *map(str, args)],
                        cwd=REPO, env=env, stdout=fo, stderr=fe))
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    failed = "timed out"
                    break
                failed = next((f"rank {r} exited {p.returncode}"
                               for r, p in enumerate(procs)
                               if p.returncode not in (None, 0)), None)
                time.sleep(0.05)
            if failed is None:
                failed = next((f"rank {r} exited {p.returncode}"
                               for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

        def read(path):
            with open(path) as f:
                return f.read()

        if failed is not None:
            raise RuntimeError(
                f"{module} on {n_ranks} ranks: {failed} after "
                f"{timeout - (deadline - time.monotonic()):.1f} s\n"
                + "\n".join(f"--- rank {r}:\n{read(o + '.out')[-2000:]}"
                            f"{read(o + '.err')[-3000:]}"
                            for r, o in enumerate(outs)))
        return [json.loads(read(o + ".out").strip().splitlines()[-1])
                for o in outs]
