"""Independent Metropolis-Hastings-Klein (IMHK), the half needed by
`IMHKSampler.sample_iid` (counterpart of the JAX package's
`samplers/imhk.py`).

An IMHK step proposes y ~ Klein and accepts with min(1, w(y) / w(x)); the
log importance weight log w(y) = sum_i log Z_i falls out of the draw. Chains
are a batch dimension: a state holds (B, n) coefficients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    KleinPrecomp,
    klein_points,
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    chain_ids,
    philox_uniform,
)

# fused IMHK steps per B2 launch (the reference's steps_per_dispatch)
STEPS_PER_LAUNCH = 64


@dataclasses.dataclass
class ChainState:
    """Per-chain MCMC state of a batch of B chains."""

    coeffs: torch.Tensor     # (B, n) integer-valued float coefficients
    log_w: torch.Tensor      # (B,) log importance weight of the state
    accepted: torch.Tensor   # (B,) int32 accepted proposals
    steps: int               # proposals made per chain


def imhk_init(pre: KleinPrecomp, num_chains: int, seed: int = 0,
              chain_offset: int = 0) -> ChainState:
    """Start B chains from one plain Klein draw each (step 0)."""
    coeffs, log_w = klein_sample_batch(pre, num_chains, seed=seed, step=0,
                                       chain_offset=chain_offset)
    return ChainState(coeffs=coeffs, log_w=log_w,
                      accepted=torch.zeros(num_chains, dtype=torch.int32,
                                           device=pre.device),
                      steps=0)


def imhk_step(state: ChainState, pre: KleinPrecomp, seed: int = 0,
              chain_offset: int = 0) -> ChainState:
    """One plain IMHK step; its Philox step index is state.steps + 1."""
    B = state.coeffs.shape[0]
    step = state.steps + 1
    y, log_w_y = klein_sample_batch(pre, B, seed=seed, step=step,
                                    chain_offset=chain_offset)
    u = philox_uniform(seed, chain_ids(B, chain_offset, pre.device), step,
                       torch.zeros(1, device=pre.device), TAG_ACCEPT)[0]
    u = torch.clamp(u.to(state.log_w.dtype), min=1e-30)
    accept = torch.log(u) < (log_w_y - state.log_w)
    return ChainState(
        coeffs=torch.where(accept[:, None], y, state.coeffs),
        log_w=torch.where(accept, log_w_y, state.log_w),
        accepted=state.accepted + accept.to(torch.int32),
        steps=step)


def estimate_burn_in(delta, eps: float = 0.01, cap: int = 10_000) -> int:
    """t_mix(eps) < -ln(eps) / delta (uniform ergodicity of IMHK)."""
    d = max(float(delta), 1e-12)
    return int(min(math.ceil(-math.log(eps) / d), cap))


def spectral_gap_mc(log_ws) -> torch.Tensor:
    """Monte-Carlo spectral-gap estimate from Klein log weights:
    delta_hat = mean(w) / max(w) = exp(logmeanexp(lw) - max(lw))."""
    lw = torch.as_tensor(log_ws).reshape(-1)
    lme = torch.logsumexp(lw, dim=0) - math.log(lw.numel())
    return torch.exp(lme - torch.max(lw))


class IMHKSampler:
    """IMHK on one lattice. Runs on `device` (the card unless asked); with
    no card and no `device="cpu"`, construction raises."""

    def __init__(self, lattice: Lattice, sigma: float, center=None,
                 window: Optional[int] = None,
                 burn_in: Optional[int] = None,
                 tail_budget: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.lattice = lattice
        self.sigma = float(sigma)
        self.pre = klein_precompute(lattice, sigma, center, window,
                                    tail_budget=tail_budget).to(self.device)
        self._ops = None
        self.acceptance_rate = None
        self.burn_in = (burn_in if burn_in is not None
                        else self._auto_burn_in())

    def _auto_burn_in(self) -> int:
        # quick MC gap estimate from a small plain Klein batch
        _, lw = klein_sample_batch(self.pre, 256, seed=0)
        return estimate_burn_in(float(spectral_gap_mc(lw)))

    @property
    def operands(self) -> klein_cuda.KleinOperands:
        if self._ops is None:
            self._ops = klein_cuda.kernel_operands(self.pre)
        return self._ops

    def sample_iid(self, seed: int, num_samples: int,
                   n_steps: Optional[int] = None,
                   return_coeffs: bool = False, backend: str = "auto"):
        """Run `num_samples` independent chains from a Klein draw (kernel
        B1), advance each `n_steps` IMHK steps (default burn_in; kernel B2,
        STEPS_PER_LAUNCH per launch) and return the final states as
        lattice points (or coefficients), (num_samples, n).

        On a CUDA device the kernels run; on the CPU their plain versions.
        backend "cuda" raises unless the sampler's device is a card."""
        if backend not in ("auto", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "cuda" and self.device.type != "cuda":
            raise RuntimeError("backend='cuda' needs the sampler on a CUDA "
                               f"device, it is on {self.device}")
        n_steps = max(1, self.burn_in if n_steps is None else int(n_steps))
        ops = self.operands
        x, lw = klein_cuda.klein_draw(ops, num_samples, seed=seed, step=0)
        acc = torch.zeros_like(lw)
        done = 0
        while done < n_steps:
            k = min(STEPS_PER_LAUNCH, n_steps - done)
            klein_cuda.imhk_fused(ops, x, lw, acc, k, seed=seed,
                                  step=1 + done)
            done += k
        self.acceptance_rate = float(acc.sum()) / (num_samples * n_steps)
        coeffs = klein_cuda.from_kernel_layout(ops, x)
        if return_coeffs:
            return coeffs
        return klein_points(self.pre.basis, coeffs)
