"""Independent Metropolis-Hastings-Klein (IMHK) and symmetric
Metropolis-Klein (SMK) chains (counterpart of the JAX package's
`samplers/imhk.py`).

An IMHK step proposes y ~ Klein and accepts with min(1, w(y) / w(x)); the
log importance weight log w(y) = sum_i log Z_i falls out of the draw. An SMK
step proposes a Klein draw of width `proposal_sigma` centred at the current
lattice point and accepts with the full Metropolis-Hastings ratio. Chains
are a batch dimension: a state holds (B, n) coefficients.

The plain chains (`imhk_chain(s)`, `smk_chain(s)`) run per-row PyTorch on
the Philox stream: on a card one CUDA graph a step, captured once and
replayed (`utils/graphs.py`), on the CPU eagerly. The samplers route to the
kernels: B1 (Klein draw), B2 (fused IMHK), B3 (IMHK trajectory) and B4
(fused SMK) on a card, their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    points_cuda,
    smk_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    ExactGuard,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    KleinPrecomp,
    klein_log_density,
    klein_points,
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.utils import graphs
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    check_backend,
    resolve_device,
    synchronize,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    chain_ids,
    philox_uniform,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

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


def _accept_uniform(seed, B, chain_offset, step, dtype, device):
    u = philox_uniform(seed, chain_ids(B, chain_offset, device), step,
                       torch.zeros(1, device=device), TAG_ACCEPT)[0]
    return torch.clamp(u.to(dtype), min=1e-30)


def _imhk_move(step, coeffs, log_w, accepted, pre: KleinPrecomp, seed,
               chain_offset):
    """The IMHK step at Philox step `step` (an int or a device counter):
    the next (coeffs, log_w, accepted)."""
    B = coeffs.shape[0]
    y, log_w_y = klein_sample_batch(pre, B, seed=seed, step=step,
                                    chain_offset=chain_offset)
    u = _accept_uniform(seed, B, chain_offset, step, log_w.dtype,
                        pre.device)
    accept = torch.log(u) < (log_w_y - log_w)
    return (torch.where(accept[:, None], y, coeffs),
            torch.where(accept, log_w_y, log_w),
            accepted + accept.to(torch.int32))


def imhk_step(state: ChainState, pre: KleinPrecomp, seed: int = 0,
              chain_offset: int = 0) -> ChainState:
    """One plain IMHK step; its Philox step index is state.steps + 1."""
    step = state.steps + 1
    return ChainState(*_imhk_move(step, state.coeffs, state.log_w,
                                  state.accepted, pre, seed, chain_offset),
                      steps=step)


def _run_chains(state: ChainState, move, n_samples: int, thin: int,
                burn_in: int):
    """burn_in steps of `move` (step, coeffs, log_w, accepted) -> the next
    three, then n_samples outer steps of `thin` steps each, keeping the
    state after each: ((C, T, n) coeffs, (C, T) log_w, final state). On a
    card the step is one CUDA graph, captured once and replayed
    (`utils/graphs.py`); on the CPU it runs eagerly."""
    (coeffs, log_w, accepted), (kept, kept_lw) = graphs.run_kept(
        move, (state.coeffs, state.log_w, state.accepted), n_samples, thin,
        burn_in, keep=(0, 1), step=state.steps)
    return kept, kept_lw, ChainState(
        coeffs, log_w, accepted, state.steps + burn_in + n_samples * thin)


def imhk_chains(pre: KleinPrecomp, n_chains: int, n_samples: int,
                thin: int = 1, burn_in: int = 0, seed: int = 0,
                chain_offset: int = 0):
    """Plain IMHK chains: a Klein start (step 0), burn_in steps, then
    n_samples kept states every thin steps. Returns coeffs (C, T, n),
    log_ws (C, T) and the final ChainState. On a card each step is a
    replay of one captured graph."""
    state = imhk_init(pre, n_chains, seed=seed, chain_offset=chain_offset)
    return _run_chains(state, lambda step, *st: _imhk_move(
        step, *st, pre, seed, chain_offset), n_samples, thin, burn_in)


def imhk_chain(pre: KleinPrecomp, n_samples: int, thin: int = 1,
               burn_in: int = 0, seed: int = 0, chain_offset: int = 0):
    """One plain IMHK chain: coeffs (T, n), log_ws (T,), final state."""
    coeffs, log_ws, state = imhk_chains(pre, 1, n_samples, thin, burn_in,
                                        seed, chain_offset)
    return coeffs[0], log_ws[0], state


# ---------------------------------------------------------------------------
# Symmetric Metropolis-Klein: Klein proposal centred at the current point.
# ---------------------------------------------------------------------------


def _scaled_centres(coeffs, pre: KleinPrecomp, lattice_Q, r_diag):
    """Q^T (B x) / R_ii per chain: the scaled Klein centre of the lattice
    point of x (B, n)."""
    return (coeffs.to(pre.basis.dtype) @ pre.basis.T) @ lattice_Q / r_diag


def _smk_move(step, coeffs, log_w, accepted, pre: KleinPrecomp, lattice_Q,
              lattice_R, seed, chain_offset):
    """The SMK step at Philox step `step` (an int or a device counter): the
    next (coeffs, log_w, accepted); log_w is passed through."""
    B = coeffs.shape[0]
    r_diag = torch.diagonal(lattice_R).to(pre.U.dtype)
    x = coeffs.to(pre.U.dtype)
    cs_x = _scaled_centres(x, pre, lattice_Q, r_diag)
    y, _ = klein_sample_batch(pre, B, seed=seed, step=step,
                              chain_offset=chain_offset, centers=cs_x)
    cs_y = _scaled_centres(y, pre, lattice_Q, r_diag)
    log_q_y_x = klein_log_density(y, dataclasses.replace(pre, cs=cs_x))
    log_q_x_y = klein_log_density(x, dataclasses.replace(pre, cs=cs_y))

    def log_pi(z):
        resid = (z @ pre.U.T - pre.cs) * r_diag
        return -0.5 * (resid * resid).sum(dim=-1) / pre.sigma ** 2

    log_ratio = log_pi(y) + log_q_x_y - log_pi(x) - log_q_y_x
    u = _accept_uniform(seed, B, chain_offset, step, log_ratio.dtype,
                        pre.device)
    accept = torch.log(u) < log_ratio
    return (torch.where(accept[:, None], y, x), log_w,
            accepted + accept.to(torch.int32))


def smk_step(state: ChainState, pre: KleinPrecomp, lattice_Q, lattice_R,
             seed: int = 0, chain_offset: int = 0) -> ChainState:
    """One plain symmetric Metropolis-Klein step; Philox step
    state.steps + 1.

    `pre` holds the proposal widths in .sigmas and the target's width and
    centre in .sigma and .cs. The proposal is a Klein draw centred at the
    current point B x; the acceptance uses the full ratio
    pi(y) q(x|y) / (pi(x) q(y|x)), both proposal densities by
    `klein_log_density` at recentered precomputations, and
    log pi(z) = -||B z - c||^2 / (2 sigma^2) = -sum_i (R_ii ((U z)_i -
    cs_i))^2 / (2 sigma^2)."""
    step = state.steps + 1
    return ChainState(*_smk_move(step, state.coeffs, state.log_w,
                                 state.accepted, pre, lattice_Q, lattice_R,
                                 seed, chain_offset),
                      steps=step)


def smk_chains(pre: KleinPrecomp, lattice_Q, lattice_R, n_chains: int,
               n_samples: int, thin: int = 1, burn_in: int = 0,
               seed: int = 0, chain_offset: int = 0):
    """Plain SMK chains from a Klein start (step 0, with `pre`'s widths):
    coeffs (C, T, n) and the final ChainState. On a card each step is a
    replay of one captured graph."""
    state = imhk_init(pre, n_chains, seed=seed, chain_offset=chain_offset)
    coeffs, _, state = _run_chains(
        state, lambda step, *st: _smk_move(step, *st, pre, lattice_Q,
                                           lattice_R, seed, chain_offset),
        n_samples, thin, burn_in)
    return coeffs, state


def smk_chain(pre: KleinPrecomp, lattice_Q, lattice_R, n_samples: int,
              thin: int = 1, burn_in: int = 0, seed: int = 0,
              chain_offset: int = 0):
    """One plain SMK chain: coeffs (T, n) and the final state."""
    coeffs, state = smk_chains(pre, lattice_Q, lattice_R, 1, n_samples,
                               thin, burn_in, seed, chain_offset)
    return coeffs[0], state


# ---------------------------------------------------------------------------
# Theory helpers.
# ---------------------------------------------------------------------------


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
        self.limbs = points_cuda.points_operands(self.pre.basis)
        self._ops = None
        self.acceptance_rate = None
        self._last_state = None
        self.burn_in = (burn_in if burn_in is not None
                        else self._auto_burn_in())

    def _auto_burn_in(self) -> int:
        # quick MC gap estimate from a small Klein batch
        with span("lgm.setup.burn_in"):
            return estimate_burn_in(self.estimate_spectral_gap(0, 256))

    def estimate_spectral_gap(self, seed: int, num_samples: int = 1000
                              ) -> float:
        """Monte-Carlo spectral gap (`spectral_gap_mc`) of num_samples Klein
        log-weights at `seed`: kernel B1 on a card, the plain per-row draw
        on the CPU."""
        if self.device.type == "cuda":
            _, lw = klein_cuda.klein_draw(self.operands, num_samples,
                                          seed=seed)
        else:
            _, lw = klein_sample_batch(self.pre, num_samples, seed=seed)
        return float(spectral_gap_mc(lw))

    @property
    def operands(self) -> klein_cuda.KleinOperands:
        if self._ops is None:
            self._ops = klein_cuda.kernel_operands(self.pre)
        return self._ops

    def _advance(self, x, lw, acc, n_steps: int, seed: int, step: int,
                 guard):
        """n_steps fused IMHK steps (B2), STEPS_PER_LAUNCH per launch,
        Philox steps step .. step + n_steps - 1, hazard C8's counters into
        `guard`."""
        done = 0
        while done < n_steps:
            k = min(STEPS_PER_LAUNCH, n_steps - done)
            klein_cuda.imhk_fused(self.operands, x, lw, acc, k, seed=seed,
                                  step=step + done, guard=guard)
            done += k

    def _output(self, coeffs, return_coeffs: bool):
        return coeffs if return_coeffs else klein_points(
            self.pre.basis, coeffs, self.limbs)

    def sample(self, seed: int, num_samples: int, thin: int = 1,
               n_chains: int = 1, return_coeffs: bool = False,
               backend: str = "auto"):
        """Trajectory semantics: `n_chains` chains from a Klein draw (B1),
        `burn_in` IMHK steps (B2), then `num_samples` kept states per chain,
        one every `thin` steps, written from inside one launch (B3).
        Returns (n_chains * num_samples, n) lattice points (or
        coefficients), chain-major. `acceptance_rate` covers the kept
        steps; `_last_state` holds the final states for resuming (Philox
        steps continue at `steps + 1`).

        On a CUDA device the kernels run; on the CPU their plain versions.
        backend "cuda" raises unless the sampler's device is a card. On a
        card n (padded to a multiple of 128) must be at most
        `klein_cuda.IMHK_TC_MAX_N_PAD` (3,456), B2 and B3's reach; above it
        they raise before any launch (the JAX package's
        `sample_iid` falls back to `imhk_chains` there)."""
        check_backend(backend, self.device)
        ops = self.operands
        guard = ExactGuard(self.device)
        x, lw = klein_cuda.klein_draw(ops, n_chains, seed=seed, step=0,
                                      guard=guard)
        acc = torch.zeros_like(lw)
        self._advance(x, lw, acc, self.burn_in, seed, 1, guard)
        acc_burn = acc.sum()    # read after the trajectory, not between
        x, lw, acc, tx, _ = klein_cuda.imhk_trajectory(
            ops, x, lw, acc, num_samples, thin, seed=seed,
            step=1 + self.burn_in, coeffs=True, guard=guard)
        guard.check("IMHKSampler.sample")
        n_steps = num_samples * thin
        self.acceptance_rate = ((float(acc.sum()) - float(acc_burn))
                                / (n_chains * n_steps))
        self._last_state = ChainState(
            coeffs=klein_cuda.from_kernel_layout(ops, x), log_w=lw,
            accepted=acc.to(torch.int32), steps=self.burn_in + n_steps)
        return self._output(klein_cuda.trajectory_coeffs(ops, tx),
                            return_coeffs)

    def sample_iid(self, seed: int, num_samples: int,
                   n_steps: Optional[int] = None,
                   return_coeffs: bool = False, backend: str = "auto"):
        """Run `num_samples` independent chains from a Klein draw (kernel
        B1), advance each `n_steps` IMHK steps (default burn_in; kernel B2,
        STEPS_PER_LAUNCH per launch) and return the final states as
        lattice points (or coefficients), (num_samples, n).

        On a CUDA device the kernels run; on the CPU their plain versions.
        backend "cuda" raises unless the sampler's device is a card. On a
        card n (padded to a multiple of 128) must be at most
        `klein_cuda.IMHK_TC_MAX_N_PAD` (3,456), B2's reach; above it B2
        raises before any launch (the JAX package's `sample_iid` falls back
        to `imhk_chains` there)."""
        with span("lgm.entry.sample_iid"):
            check_backend(backend, self.device)
            n_steps = max(1, self.burn_in if n_steps is None
                          else int(n_steps))
            ops = self.operands
            guard = ExactGuard(self.device)
            x, lw = klein_cuda.klein_draw(ops, num_samples, seed=seed,
                                          step=0, guard=guard)
            acc = torch.zeros_like(lw)
            self._advance(x, lw, acc, n_steps, seed, 1, guard)
            guard.check("IMHKSampler.sample_iid")
            with span("lgm.sync.acceptance"):
                self.acceptance_rate = (float(acc.sum())
                                        / (num_samples * n_steps))
            self._last_state = None
            with span("lgm.layout.coeffs"):
                coeffs = klein_cuda.from_kernel_layout(ops, x)
            return self._output(coeffs, return_coeffs)

    def diagnose_convergence(self, seed: int, num_samples: int = 1000
                             ) -> dict:
        """`sample(seed, num_samples)` (one chain: B1 start, B2 burn-in, B3
        trajectory on a card), timed to its end, with its acceptance, the
        spectral-gap estimate at seed + 1 and the points' moments."""
        synchronize(self.device)
        t0 = time.perf_counter()
        pts = self.sample(seed, num_samples)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        return {
            "acceptance_rate": self.acceptance_rate,
            "spectral_gap_estimate": self.estimate_spectral_gap(
                seed + 1, min(num_samples, 1000)),
            "empirical_mean": torch.mean(pts, dim=0),
            "empirical_std": torch.std(pts, dim=0, correction=0),
            "theoretical_std": self.sigma * torch.ones(
                self.lattice.n, dtype=pts.dtype, device=pts.device),
            "samples_per_second": num_samples / dt,
        }


class MetropolisKleinSampler:
    """Symmetric Metropolis-Klein (a Klein proposal of width
    `proposal_sigma` centred at the current lattice point, full MH ratio).
    `sample` runs the plain chain (trajectory semantics); `sample_iid` runs
    independent chains through kernels B1 and B4 on a card, their plain
    versions on the CPU. Runs on `device` (the card unless asked)."""

    def __init__(self, lattice: Lattice, sigma: float, proposal_sigma=None,
                 center=None, window: Optional[int] = None,
                 tail_budget: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.lattice = lattice
        self.sigma = float(sigma)
        self.proposal_sigma = float(proposal_sigma if proposal_sigma
                                    is not None else sigma)
        # target precomputation (the kernel takes the proposal widths
        # apart) ...
        self._target_pre = klein_precompute(
            lattice, sigma, center, window,
            tail_budget=tail_budget).to(self.device)
        # ... and the plain chain's hybrid: proposal widths in .sigmas,
        # target width and centre in .sigma and .cs
        r_diag = torch.diagonal(lattice.R).to(self.device)
        self.pre = dataclasses.replace(
            self._target_pre, sigmas=self.proposal_sigma / r_diag)
        self.limbs = points_cuda.points_operands(self.pre.basis)
        self._Q = lattice.Q.to(self.device)
        self._R = lattice.R.to(self.device)
        self._klein_ops = None
        self._smk_ops = None
        self.acceptance_rate = None

    @property
    def klein_operands(self) -> klein_cuda.KleinOperands:
        """B1's operands for the target: the Klein start."""
        if self._klein_ops is None:
            self._klein_ops = klein_cuda.kernel_operands(self._target_pre)
        return self._klein_ops

    @property
    def operands(self) -> smk_cuda.SMKOperands:
        """B4's operands."""
        if self._smk_ops is None:
            self._smk_ops = smk_cuda.smk_operands(
                self._target_pre, self.proposal_sigma,
                klein_ops=self.klein_operands)
        return self._smk_ops

    def sample(self, seed: int, num_samples: int, thin: int = 1,
               burn_in: int = 0, n_chains: int = 1,
               return_coeffs: bool = False):
        """Plain SMK chains from a Klein start: burn_in steps, then
        num_samples kept states every thin steps. Returns
        (n_chains * num_samples, n) points (or coefficients), chain-major."""
        coeffs, state = smk_chains(self.pre, self._Q, self._R, n_chains,
                                   num_samples, thin, burn_in, seed)
        self.acceptance_rate = float(state.accepted.sum()) / max(
            n_chains * state.steps, 1)
        coeffs = coeffs.reshape(-1, self.lattice.n)
        return coeffs if return_coeffs else klein_points(
            self.pre.basis, coeffs, self.limbs)

    def sample_iid(self, seed: int, num_samples: int, n_steps: int = 64,
                   return_coeffs: bool = False, backend: str = "auto"):
        """`num_samples` independent SMK chains from a Klein draw of the
        target (B1), `n_steps` fused SMK steps each (B4, one launch);
        returns the final states, (num_samples, n). Hazard C8's guard (the
        start's and B4's rows) is read once, after the launches. On a card n
        (padded to a multiple of 128) must be at most
        `smk_cuda.SMK_TC_MAX_N_PAD` (3,456), B4's reach; above it B4 raises
        before its launch."""
        check_backend(backend, self.device)
        n_steps = max(1, int(n_steps))
        kops = self.klein_operands
        guard = ExactGuard(self.device)
        x, _ = klein_cuda.klein_draw(kops, num_samples, seed=seed, step=0,
                                     guard=guard)
        acc = torch.zeros(num_samples, dtype=x.dtype, device=x.device)
        smk_cuda.smk_steps(self.operands, x, acc, n_steps, seed=seed, step=1,
                           guard=guard)
        guard.check("SMKSampler.sample_iid")
        self.acceptance_rate = float(acc.sum()) / (num_samples * n_steps)
        coeffs = klein_cuda.from_kernel_layout(kops, x)
        return coeffs if return_coeffs else klein_points(
            self.pre.basis, coeffs, self.limbs)


# the north star names the chain "symmetric Metropolis-Klein" (SMK)
SMKSampler = MetropolisKleinSampler
