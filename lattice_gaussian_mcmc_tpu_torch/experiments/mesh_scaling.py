"""Weak-scaling measurement of the sharded paths (counterpart of the JAX
package's `experiments/mesh_scaling.py`): chains a rank fixed, the world
size growing; efficiency = rate at W ranks / (W x rate at 1 rank). Chains
are independent and only diagnostics communicate, so the target is >= 80%
where each rank has its own compute.

Rows, each labelled with the device it ran on:
  * card rows (`card_rows`): on a card, world size 1 under NCCL, in this
    process: the per-row chains (`measure_scaling`), the kernel path B1 +
    B2 (`measure_scaling_kernels`, `sharded_imhk_blocked`) and B5
    (`measure_scaling_peikert`), with the launches each made;
  * the reference's curve (`rows`, `pallas_rows`, `peikert_rows`): the JAX
    package runs it on a virtual 8-device CPU mesh when fewer devices are
    visible; here 8 gloo CPU ranks, one process each
    (`_mesh_scaling_worker`), the curve on the meshes of their first 1, 2,
    4 and 8, environment "gloo_cpu_ranks";
  * `process_rows`: 1 and 2 gloo processes on the JAX process worker's
    problem (`_process_scaling_worker`).
The CPU rows are the reference's own measurement, not a stand-in for the
card's: without a card and without `device="cpu"` `run_mesh_scaling` raises
(`resolve_device`). CPU ranks share the host's cores, so their efficiency
is a lower bound.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ExperimentConfig,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    launch_record,
    peikert_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.parallel.collectives import (
    sharded_imhk_blocked,
    sharded_imhk_chains,
    sharded_peikert,
)
from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import (
    ChainMesh,
    all_reduce_sum,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    peikert_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

CPU_RANK_COUNTS = (1, 2, 4, 8)
PROCESS_COUNTS = (1, 2)
RANKS_TIMEOUT_S = 600.0
# the kernel rows: chains a rank, B2 steps and B5 rounds
KERNEL_CHAINS_PER_RANK = 256
KERNEL_STEPS = 8
PEIKERT_ROUNDS = 2


def _lattice(n: int, seed: int, device):
    """The JAX rows' basis: unit upper triangle, entries in [-0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    B = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
    np.fill_diagonal(B, 1.0)
    return lattice_from_basis(B, dtype=torch.float32, device=device), B


def kernel_row_problem(device, n: int = 8, seed: int = 0):
    """The kernel rows' problem on `device`: the Klein precomputation of
    `_lattice` at sigma 1.2 (B1 + B2) and its Peikert operands at sigma
    3 s1(B), window 16 (B5)."""
    lat, B = _lattice(n, seed, device)
    pre = peikert_precompute(lat, 3.0 * float(np.linalg.norm(B, 2)))
    return (klein_precompute(lat, 1.2),
            peikert_cuda.peikert_operands(pre, window=16))


def _sync(mesh: ChainMesh):
    """Wait for this rank's device and for every rank."""
    synchronize(mesh.device)
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)


def _timed(mesh: ChainMesh, run):
    """(result, seconds) of `run()` between two synchronisations."""
    _sync(mesh)
    t0 = time.perf_counter()
    out = run()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _launches():
    rec = launch_record.read()
    return {k: rec[k]["launches"]
            for k in ("klein_draw", "imhk_fused", "peikert_rounds")}


def _row(mesh: ChainMesh, n_chains: int, samples: int, seconds: float,
         before: Dict[str, int], **kw) -> Dict:
    after = _launches()
    return {"n_devices": mesh.size, "n_chains": n_chains,
            "samples_per_sec": samples / seconds, "seconds": seconds,
            "device": mesh.device.type, "backend": mesh.backend,
            "launches": {k: after[k] - before[k] for k in after}, **kw}


def measure_scaling(mesh: ChainMesh, n: int = 32, chains_per_device: int = 64,
                    n_samples: int = 20, seed: int = 0) -> Dict:
    """The per-row chains (`sharded_imhk_chains`, sigma 1.2) at this
    mesh's world size: a warm-up run, then a timed one."""
    lat, _ = _lattice(n, seed, mesh.device)
    pre = klein_precompute(lat, 1.2)
    n_chains = chains_per_device * mesh.size
    sharded_imhk_chains(pre, n_chains, n_samples, mesh, seed=seed)
    before = _launches()
    out, dt = _timed(mesh, lambda: sharded_imhk_chains(
        pre, n_chains, n_samples, mesh, seed=seed + 1))
    return _row(mesh, n_chains, n_chains * n_samples, dt, before,
                impl="sharded_imhk_chains",
                acceptance=out[2]["acceptance_rate"])


def measure_scaling_kernels(mesh: ChainMesh, n: int = 8,
                            chains_per_device: int = KERNEL_CHAINS_PER_RANK,
                            n_steps: int = KERNEL_STEPS,
                            seed: int = 0) -> Dict:
    """The kernel path (`sharded_imhk_blocked`: B1 then one B2 launch on a
    card, their plain versions on the CPU) at this mesh's world size."""
    pre, _ = kernel_row_problem(mesh.device, n, seed)
    n_chains = chains_per_device * mesh.size
    sharded_imhk_blocked(pre, n_chains, n_steps, mesh, seed=seed)
    before = _launches()
    out, dt = _timed(mesh, lambda: sharded_imhk_blocked(
        pre, n_chains, n_steps, mesh, seed=seed + 1))
    return _row(mesh, n_chains, n_chains * n_steps, dt, before,
                impl="sharded_imhk_blocked", acceptance=out[3])


def measure_scaling_peikert(mesh: ChainMesh, n: int = 8,
                            chains_per_device: int = KERNEL_CHAINS_PER_RANK,
                            n_rounds: int = PEIKERT_ROUNDS,
                            seed: int = 0) -> Dict:
    """The sharded Peikert path (`sharded_peikert`, window 16, sigma
    3 s1(B): B5 on a card) at this mesh's world size."""
    _, ops = kernel_row_problem(mesh.device, n, seed)
    n_chains = chains_per_device * mesh.size
    sharded_peikert(ops, n_chains, mesh, n_rounds, seed=seed)
    before = _launches()
    out, dt = _timed(mesh, lambda: sharded_peikert(
        ops, n_chains, mesh, n_rounds, seed=seed + 1))
    return _row(mesh, n_chains, n_chains * n_rounds, dt, before,
                impl="sharded_peikert", pooled_var_max=float(out[2].max()))


def scaling_rows(mesh: ChainMesh, chains_per_device: int = 64,
                 n_samples: int = 20, seed: int = 0) -> Dict[str, List]:
    """The three rows at this mesh's world size (the kernel rows at their
    own sizes: 256 chains a rank, 8 steps or 2 rounds)."""
    return {"rows": [measure_scaling(mesh, chains_per_device=
                                     chains_per_device,
                                     n_samples=n_samples, seed=seed)],
            "pallas_rows": [measure_scaling_kernels(mesh, seed=seed)],
            "peikert_rows": [measure_scaling_peikert(mesh, seed=seed)]}


def _with_efficiency(rows: List[Dict], key: str = "n_devices",
                     out: str = "efficiency") -> List[Dict]:
    base = next(r for r in rows if r[key] == 1)["samples_per_sec"]
    for r in rows:
        r[out] = r["samples_per_sec"] / (base * r[key])
    return rows


def measure_on_cpu_ranks(rank_counts=CPU_RANK_COUNTS,
                         chains_per_device: int = 64, n_samples: int = 20,
                         seed: int = 0) -> Dict[str, List]:
    """The reference's curve on gloo CPU ranks: max(W) processes of
    `_mesh_scaling_worker` in one group, each count W on the mesh of the
    first W ranks (as the JAX curve takes the first W devices); rows with
    their efficiencies."""
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import run_ranks
    out = run_ranks(
        "lattice_gaussian_mcmc_tpu_torch.experiments._mesh_scaling_worker",
        max(rank_counts), [chains_per_device, n_samples, seed, *rank_counts],
        timeout=RANKS_TIMEOUT_S)[0]
    return {k: _with_efficiency(v) for k, v in out.items()}


def measure_process_scaling(process_counts=PROCESS_COUNTS,
                            chains_per_device: int = 128,
                            n_samples: int = 20) -> List[Dict]:
    """Process-spanning weak scaling: N gloo CPU processes on the JAX
    process worker's problem (n = 16, sigma 1.2), chains a process fixed.
    On one host the processes share its cores: a lower bound."""
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import run_ranks
    rows = [run_ranks(
        "lattice_gaussian_mcmc_tpu_torch.experiments._process_scaling_worker",
        nproc, [chains_per_device, n_samples], timeout=RANKS_TIMEOUT_S)[0]
        for nproc in process_counts]
    return _with_efficiency(rows, "process_count", "efficiency_vs_1proc")


def card_rows(device: torch.device, seed: int = 0) -> List[Dict]:
    """The three rows at world size 1 under NCCL on the card, in this
    process: the group is set up through a localhost coordinator and
    destroyed after. Raises if the process is already in a group."""
    import torch.distributed as dist

    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        free_port,
        global_mesh,
        init_runtime,
        shutdown_runtime,
    )
    if dist.is_initialized():
        raise RuntimeError("card_rows sets up a world-size-1 group of its "
                           "own; this process is already in one")
    init_runtime(f"tcp://127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        rows = scaling_rows(global_mesh(device), seed=seed)
    finally:
        shutdown_runtime()
    return [r for k in ("rows", "pallas_rows", "peikert_rows")
            for r in _with_efficiency(rows[k])]


def _finite_rates(rows) -> bool:
    return all(math.isfinite(r["samples_per_sec"]) and r["samples_per_sec"]
               > 0 for r in rows)


def run_mesh_scaling(cfg: Optional[ExperimentConfig] = None,
                     device=None) -> Dict:
    """The card rows (unless `device` is the CPU), the CPU-rank curve and
    the process rows, written to `mesh_scaling.json`. all_passed: every
    rate finite and positive, the 2-process row spanned processes, the
    kernel path ran on the widest CPU-rank count with acceptance in
    (0, 1], and on a card its kernel rows launched B1, B2 and B5, the
    kernel row with acceptance in (0, 1]."""
    cfg = cfg or ExperimentConfig(output_dir="results/mesh_scaling")
    device = resolve_device(device)
    card = card_rows(device, cfg.seed) if device.type == "cuda" else []
    cpu = measure_on_cpu_ranks(CPU_RANK_COUNTS, seed=cfg.seed)
    try:
        process_rows = measure_process_scaling()
    except RuntimeError as e:   # record the failure with the other rows
        process_rows = [{"error": str(e)}]
    widest = max(r["n_devices"] for r in cpu["pallas_rows"])
    card_ok = device.type != "cuda" or any(
        r["impl"] == "sharded_imhk_blocked" and 0.0 < r["acceptance"] <= 1.0
        and r["launches"]["klein_draw"] > 0
        and r["launches"]["imhk_fused"] > 0 for r in card) and any(
        r["impl"] == "sharded_peikert" and r["launches"]["peikert_rounds"]
        > 0 for r in card)
    payload = {
        **cpu,
        "card_rows": card,
        "process_rows": process_rows,
        "environment": "gloo_cpu_ranks",
        "card": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else None),
        "physical_cores": multiprocessing.cpu_count(),
        "all_passed": bool(
            _finite_rates(card + cpu["rows"] + cpu["pallas_rows"]
                          + cpu["peikert_rows"])
            and any(r.get("process_count") == 2 and r.get("distributed")
                    for r in process_rows)
            and any(r["n_devices"] == widest
                    and 0.0 < r["acceptance"] <= 1.0
                    for r in cpu["pallas_rows"])
            and card_ok),
        "note": ("CPU ranks share the host's cores, so their weak-scaling "
                 "efficiency is a lower bound; the >= 80% target applies "
                 "where each rank has its own compute"),
    }
    out_dir = cfg.ensure_output()
    with open(os.path.join(out_dir, "mesh_scaling.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    return payload
