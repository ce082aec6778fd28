"""Sharded sampling and the collective diagnostics (counterpart of the JAX
package's `parallel/collectives.py`).

Each rank runs its own chain range (`mesh.shard_range`) and returns its
local block; acceptance, moments and the between/within-chain variances of
R-hat come from all-reduced sums, so a diagnostic moves a handful of
scalars or (n,) vectors and chains never move. Sums are reduced in float64
and counts in int64: on the card under NCCL, through host copies under
gloo. An acceptance rate is formed as the JAX package forms it: the float32
quotient of the two int64 counts.

Kernel paths: `sharded_imhk_blocked` (the JAX package's
`sharded_imhk_blocked` and `sharded_imhk_pallas` in one function) draws
with kernel B1 at Philox step 0 and runs one B2 launch over steps
1..n_steps on CUDA tensors, their plain versions on CPU tensors;
`sharded_peikert` (the JAX `sharded_peikert_pallas`) runs B5 the same way.
Every rank keys its draws by global chain id (`chain_offset`), so the
gathered result is the same at any world size (`parallel/mesh.py`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import (
    ChainMesh,
    all_reduce_sum,
    shard_range,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import imhk_chains
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    KleinPrecomp,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)


def _local_chains(n_chains: int, mesh: ChainMesh) -> Tuple[int, int]:
    """(chain_offset, count) of this rank's chains."""
    chains = shard_range(n_chains, mesh)
    return chains.start, len(chains)


def _ratio(accepted, total) -> float:
    """accepted / max(total, 1) in float32, as the JAX package divides."""
    return float(np.float32(int(accepted)) / np.float32(max(int(total), 1)))


def _counts(values, mesh: ChainMesh, device) -> torch.Tensor:
    """All-reduced int64 counts."""
    return all_reduce_sum(torch.stack([torch.as_tensor(v, device=device)
                                       .to(torch.int64) for v in values]),
                          mesh)


def sharded_klein_batch(pre: KleinPrecomp, n_samples: int, mesh: ChainMesh,
                        seed: int = 0):
    """Plain per-row Klein draws of this rank's samples (step 0). Returns
    the local (coeffs (C_local, n), log_ws (C_local,))."""
    offset, count = _local_chains(n_samples, mesh)
    return klein_sample_batch(pre, count, seed=seed, step=0,
                              chain_offset=offset)


def sharded_imhk_chains(pre: KleinPrecomp, n_chains: int, n_samples: int,
                        mesh: ChainMesh, thin: int = 1, burn_in: int = 0,
                        seed: int = 0):
    """Plain per-row IMHK chains (`imhk_chains`) on this rank's chains.
    Returns the local coeffs (C_local, T, n) and log_ws (C_local, T), and
    stats replicated on every rank: acceptance_rate (float), per-coordinate
    mean and std over all chains and kept states (float64 (n,)) and
    n_total (int)."""
    offset, count = _local_chains(n_chains, mesh)
    coeffs, log_ws, state = imhk_chains(pre, count, n_samples, thin, burn_in,
                                        seed, chain_offset=offset)
    g = _counts([state.accepted.sum(), count * state.steps,
                 count * coeffs.shape[1]], mesh, pre.device)
    x = coeffs.to(torch.float64)
    s = all_reduce_sum(torch.stack([x.sum((0, 1)), (x * x).sum((0, 1))]),
                       mesh)
    cnt = int(g[2])
    mean = s[0] / cnt
    var = s[1] / cnt - mean ** 2
    stats = {"acceptance_rate": _ratio(g[0], g[1]), "mean": mean,
             "std": torch.sqrt(torch.clamp(var, min=0.0)), "n_total": cnt}
    return coeffs, log_ws, stats


def global_acceptance(accepted: torch.Tensor, steps,
                      mesh: ChainMesh) -> float:
    """Pooled acceptance over every rank's chains: `accepted` (C_local,)
    counts and `steps` their proposals, per chain (C_local,) or one
    number for all (the port's `ChainState.steps`)."""
    steps = torch.as_tensor(steps, device=accepted.device)
    total = steps.sum() if steps.dim() else steps * accepted.numel()
    g = _counts([accepted.sum(), total], mesh, accepted.device)
    return _ratio(g[0], g[1])


def global_moments(x: torch.Tensor, mesh: ChainMesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global mean and std (float64) of a chain-sharded (C_local, ..., d)
    tensor over every axis but the last."""
    axes = tuple(range(x.dim() - 1))
    xd = x.to(torch.float64)
    s = all_reduce_sum(torch.stack([xd.sum(axes), (xd * xd).sum(axes)]),
                       mesh)
    cnt = int(_counts([math.prod(x.shape[:-1])], mesh, x.device)[0])
    mean = s[0] / cnt
    var = s[1] / cnt - mean ** 2
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def global_gelman_rubin(chains: torch.Tensor, mesh: ChainMesh) -> float:
    """R-hat of chain-sharded (C_local, T) scalar chains, from all-reduced
    within- and between-chain sums (no chain data moves)."""
    x = chains.to(torch.float64)
    T = x.shape[1]
    means = x.mean(1)
    s = all_reduce_sum(torch.stack([x.var(1, correction=1).sum(),
                                    means.sum()]), mesh)
    C = int(_counts([x.shape[0]], mesh, x.device)[0])
    W = s[0] / C
    gm = s[1] / C
    B = T * all_reduce_sum(((means - gm) ** 2).sum(), mesh) / (C - 1)
    var_hat = (T - 1) / T * W + B / T
    return float(torch.sqrt(var_hat / torch.clamp(W, min=1e-300)))


def sharded_imhk_blocked(pre: KleinPrecomp, n_chains: int, n_steps: int,
                         mesh: ChainMesh, seed: int = 0):
    """The production path on this rank's chains: a Klein start at Philox
    step 0 (kernel B1 on a card) and n_steps IMHK steps at steps
    1..n_steps in one B2 launch; on the CPU their plain versions. Returns
    the local (coeffs (C_local, n), log_ws (C_local,), accepted
    (C_local,) int32) and the pooled acceptance (float)."""
    offset, count = _local_chains(n_chains, mesh)
    X0, lw0 = klein_sample_batch_blocked(pre, count, seed=seed, step=0,
                                         chain_offset=offset)
    X, lw, acc = imhk_steps_batch_blocked(pre, X0, lw0, n_steps, seed=seed,
                                          step=1, chain_offset=offset)
    g = _counts([acc.sum(), count * n_steps], mesh, acc.device)
    return X, lw, acc, _ratio(g[0], g[1])


def sharded_peikert(ops: peikert_cuda.PeikertOperands, n_chains: int,
                    mesh: ChainMesh, n_rounds: int = 1, seed: int = 0):
    """Peikert's sampler on this rank's chains: n_rounds independent draws
    a chain in one launch of kernel B5 (its plain version on the CPU), with
    the pooled per-coordinate mean and variance all-reduced (the draws are
    i.i.d.; there is no acceptance). `ops` from
    `peikert_cuda.peikert_operands(pre, window)`. Returns the local
    coefficients (C_local * n_rounds, n), chain-major (chain c's rounds
    adjacent, so the gathered array does not depend on the world size),
    and the pooled mean and variance (float64 (n,))."""
    offset, count = _local_chains(n_chains, mesh)
    ring = peikert_cuda.peikert_rounds(ops, count, n_rounds, seed=seed,
                                       chain_offset=offset)
    X = peikert_cuda.ring_coeffs(ops, ring).transpose(0, 1).reshape(
        count * n_rounds, ops.n)
    del ring
    s1 = X.sum(0, dtype=torch.float64)
    s2 = X.to(torch.float64).square_().sum(0)
    s = all_reduce_sum(torch.stack([s1, s2]), mesh)
    tot = int(_counts([X.shape[0]], mesh, X.device)[0])
    mean = s[0] / tot
    return X, mean, s[1] / tot - mean * mean

