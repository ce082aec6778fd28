"""The chain mesh: chains split over the ranks of a process group
(counterpart of the JAX package's `parallel/mesh.py`).

The JAX package shards the chain axis over a `jax.sharding.Mesh` with
`shard_map`. Here each rank is one process with one device, and the mesh
is the process group: rank r of W runs chains [r C / W, (r + 1) C / W),
every draw of that rank with `chain_offset = r C / W`. The Philox stream
is keyed by (seed, global chain id, step, row) (`utils/prng.py`), so every
sharded path, the kernel paths included, gives the same bits at any world
size (on the CPU, at one BLAS thread count: the plain versions' matrix
products at large n sum in an order that follows it). That is stronger
than the JAX package, whose kernel paths key each device
(`chain_keys(key, mesh.size)`), so that their draws there depend on the
mesh. Only diagnostics communicate: a few all-reduced sums.

At world size 1 with no process group the reductions are the identity
and nothing is communicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device

CHAIN_AXIS = "chains"


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """One rank's view of the chain mesh: its process group (None: no
    group, world size 1), rank, world size and device, and the group's
    backend."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None


def make_mesh(device=None, n_ranks: Optional[int] = None
              ) -> Optional[ChainMesh]:
    """The mesh over the default process group, or the world-size-1 mesh
    when no group is initialised; `device` as `resolve_device` takes it
    (None: the card). With `n_ranks`, the mesh over the group's first
    n_ranks ranks (the JAX `make_mesh(n_devices)`): every rank must make
    the call, and a rank outside those gets None."""
    device = resolve_device(device)
    if not dist.is_initialized():
        return ChainMesh(None, 0, 1, device)
    group = dist.group.WORLD
    if n_ranks is not None:
        group = dist.new_group(list(range(n_ranks)))
        if dist.get_rank() >= n_ranks:
            return None
    return ChainMesh(group, dist.get_rank(group), dist.get_world_size(group),
                     device, dist.get_backend())


def shard_range(n_chains: int, mesh: ChainMesh) -> range:
    """This rank's global chain ids: [r C / W, (r + 1) C / W). Hazard C6:
    the world size must divide the chains."""
    if n_chains % mesh.size:
        raise ValueError(f"the world size {mesh.size} must divide the "
                         f"chains ({n_chains})")
    per = n_chains // mesh.size
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def _through_host(mesh: ChainMesh) -> bool:
    # NCCL reduces on the card; gloo takes host tensors
    return mesh.backend != "nccl"


def all_reduce_sum(t: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor on t's device); the
    identity without a group."""
    if mesh.group is None:
        return t.clone()
    buf = t.to("cpu", copy=True) if _through_host(mesh) else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """Every rank's (C_local, ...) block concatenated in rank order along
    the leading (chain) axis, on t's device; `t` itself without a group."""
    if mesh.group is None:
        return t
    buf = t.contiguous().cpu() if _through_host(mesh) else t.contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(t.device)
