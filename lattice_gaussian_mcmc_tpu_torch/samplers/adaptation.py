"""Sigma / mixing-parameter adaptation for lattice Gaussian MCMC
(counterpart of the JAX package's `samplers/adaptation.py`).

Adaptation runs on windowed pooled statistics (the acceptance of the whole
chain batch), driving a Robbins-Monro update of log sigma between windows
of chain steps. Only the scalar width changes between windows.

Routes. `adapt_sigma_imhk` draws and steps through the blocked route
(kernels B1 and B2 on a card). `adapt_sigma_smk` runs its windows through
kernel B4 on a card, with the chain state kept in B4's layout across
windows, and through the plain per-row `smk_step` on the CPU
(`_smk_window_plain`, the counterpart of the JAX `_smk_window_xla`).
Where the JAX functions take a key, these take an integer seed; window w
of `adapt_sigma_imhk` runs at seed + w, and `adapt_sigma_smk`'s windows
run at one seed on consecutive, disjoint Philox steps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, smk_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    ExactGuard,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import ChainState, smk_step
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import synchronize


@dataclass
class AdaptationState:
    """Host-side adaptation bookkeeping. `coeffs`, set by
    `adapt_sigma_smk`, holds the chains' final coefficients (B, n)."""

    log_sigma: float
    step: int = 0
    history: List[dict] = field(default_factory=list)
    coeffs: Optional[torch.Tensor] = None

    @property
    def sigma(self) -> float:
        return math.exp(self.log_sigma)


def robbins_monro_update(state: AdaptationState, observed: float,
                         target: float, gain0: float = 0.5,
                         decay: float = 0.6) -> AdaptationState:
    """log sigma_{t+1} = log sigma_t + gamma_t (target - observed), gamma_t
    = gain0 / (1 + t)^decay: IMHK acceptance increases with sigma, so to
    raise the acceptance sigma is raised."""
    gamma = gain0 / (1.0 + state.step) ** decay
    new_log = state.log_sigma + gamma * (target - observed) * 1.0
    return AdaptationState(log_sigma=new_log, step=state.step + 1,
                           history=state.history)


def adapt_sigma_imhk(lattice: Lattice, sigma0: float,
                     target_acceptance: float = 0.9,
                     n_windows: int = 12, window_steps: int = 4,
                     n_chains: int = 1024,
                     sigma_floor: Optional[float] = None,
                     seed: int = 0) -> AdaptationState:
    """Adapt sigma so the pooled IMHK acceptance hits `target_acceptance`.

    Each window w: the Klein precomputation at the current sigma, a fresh
    blocked Klein draw at seed + w (B1 on a card), `window_steps` fused
    IMHK steps (one B2 launch), the pooled acceptance, a Robbins-Monro
    update. Runs on the lattice's device. Returns the adaptation state
    with its history."""
    if sigma_floor is None:
        # Klein validity floor: below it the proposal is badly truncated
        sigma_floor = float(torch.max(lattice.gs_norms)) / math.sqrt(
            2.0 * math.log(lattice.n + 1.0))
    st = AdaptationState(log_sigma=math.log(sigma0))
    for w in range(n_windows):
        sigma = max(st.sigma, sigma_floor)
        pre = klein_precompute(lattice, sigma)
        X0, lw0 = klein_sample_batch_blocked(pre, n_chains, seed=seed + w)
        _, _, acc = imhk_steps_batch_blocked(pre, X0, lw0, window_steps,
                                             seed=seed + w, step=1)
        acc_rate = float(acc.to(torch.float64).mean()) / window_steps
        st.history.append({"window": w, "sigma": sigma,
                           "acceptance": acc_rate})
        st = robbins_monro_update(st, acc_rate, target_acceptance)
        st.log_sigma = max(st.log_sigma, math.log(sigma_floor))
    st.log_sigma = max(st.log_sigma, math.log(sigma_floor))
    return st


def _hybrid(pre_t, lattice: Lattice, sigma_prop: float):
    """The plain SMK step's precomputation: the proposal widths sigma_prop
    / R_ii in .sigmas, the target's width and centre in .sigma and .cs."""
    r_diag = torch.diagonal(lattice.R).to(pre_t.U.device, pre_t.U.dtype)
    return dataclasses.replace(pre_t, sigmas=sigma_prop / r_diag)


def _smk_window_plain(pre_h, Q, R, X, n_steps: int, seed: int, step: int):
    """`n_steps` plain SMK steps (`smk_step`) on the coefficients X (B, n)
    at Philox steps step .. step + n_steps - 1. Returns (X, accepted
    fraction)."""
    B = X.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=X.device)
    st = ChainState(coeffs=X, log_w=torch.zeros(B, dtype=X.dtype,
                                                device=X.device),
                    accepted=zeros, steps=step - 1)
    for _ in range(n_steps):
        st = smk_step(st, pre_h, Q, R, seed=seed)
    return st.coeffs, float(st.accepted.to(torch.float64).sum()) / (
        B * n_steps)


def _smk_start_card(pre_t, n_chains: int, seed: int):
    """The chains' Klein start at the target width, B1 at step 0, in B4's
    layout: (B1's operands, recentred x (n_pad, B), the C8 guard that the
    windows' B4 launches share)."""
    kops = klein_cuda.kernel_operands(pre_t)
    guard = ExactGuard(kops.device)
    x, _ = klein_cuda.klein_draw(kops, n_chains, seed=seed, step=0,
                                 guard=guard)
    return kops, x, guard


def _smk_window_card(pre_t, kops, x, sigma_prop: float, n_steps: int,
                     seed: int, step: int, guard) -> Tuple[float, int]:
    """`n_steps` SMK steps of B4 (one launch) on the recentred state x
    (n_pad, B) in place, at Philox steps step .. step + n_steps - 1, C8's
    counters into `guard`. Returns the accepted fraction (one
    synchronisation) and the window B4 took at this width."""
    sops = smk_cuda.smk_operands(pre_t, sigma_prop, klein_ops=kops)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    smk_cuda.smk_steps(sops, x, acc, n_steps, seed=seed, step=step,
                       guard=guard)
    return (float(acc.sum(dtype=torch.float64)) / (x.shape[1] * n_steps),
            sops.window)


def adapt_sigma_smk(lattice: Lattice, sigma: float,
                    sigma_prop0: Optional[float] = None,
                    target_acceptance: float = 0.45,
                    n_windows: int = 16, window_steps: int = 8,
                    n_chains: int = 4096, grow_windows: bool = True,
                    warmup_windows: int = 4,
                    max_window_steps: int = 128,
                    seed: int = 0) -> AdaptationState:
    """Robbins-Monro on the symmetric Metropolis-Klein PROPOSAL width,
    targeting the pooled acceptance. Acceptance decreases in sigma_prop,
    so the update is log sigma_prop += gamma (observed - target), gamma =
    0.5 / (1 + t)^0.6. The chain state persists across windows
    (diminishing adaptation, which keeps the chain ergodic).

    After `warmup_windows` windows (with `grow_windows`) the step count of
    a window jumps once to `max_window_steps`: the gain has decayed by
    then, so late windows need estimate precision, not update frequency.

    Runs on the lattice's device. On a card: the chains start from one B1
    draw at the target width (Philox step 0) and each window is one B4
    launch whose steps follow the last window's (window w starts at step 1
    + the steps of windows 0 .. w-1), so no two windows read the same
    random numbers; the state stays in B4's recentred layout until the
    end, B1's operands (and U's fragments) are built once, and the C8
    guard of B1 and B4 is read once, after the last window. Any chain
    count runs (a B4 block owns 32 chains and masks the rest). On the
    CPU: a blocked Klein start and `_smk_window_plain`. The JAX package's
    `backend` and `tile` (its Pallas path's TPU tiling, with its
    n_chains % 256 condition) have no counterpart.

    Returns the AdaptationState; .history rows carry (window, sigma_prop,
    acceptance, window_steps, window_s, samples_per_sec), each window
    synchronised before its clock is read, and on a card also the window
    B4 took at that width (`b4_window`); .coeffs holds the final chain
    states (B, n)."""
    n = lattice.n
    if sigma_prop0 is None:
        sigma_prop0 = 2.38 * float(sigma) / math.sqrt(n)
    pre_t = klein_precompute(lattice, sigma)
    device = pre_t.device
    on_card = device.type == "cuda"
    if on_card:
        kops, x, guard = _smk_start_card(pre_t, n_chains, seed)
    else:
        X, _ = klein_sample_batch_blocked(pre_t, n_chains, seed=seed)
    st = AdaptationState(log_sigma=math.log(sigma_prop0))
    step = 1
    for w in range(n_windows):
        sp = st.sigma
        steps_w = window_steps
        if grow_windows and w >= warmup_windows:
            steps_w = max_window_steps
        synchronize(device)
        t0 = time.perf_counter()
        row = {}
        if on_card:
            acc_rate, row["b4_window"] = _smk_window_card(
                pre_t, kops, x, sp, steps_w, seed, step, guard)
        else:
            X, acc_rate = _smk_window_plain(_hybrid(pre_t, lattice, sp),
                                            lattice.Q, lattice.R, X,
                                            steps_w, seed, step)
        synchronize(device)
        dt = time.perf_counter() - t0
        step += steps_w
        st.history.append({
            "window": w, "sigma_prop": sp, "acceptance": acc_rate,
            "window_steps": steps_w, "window_s": dt,
            "samples_per_sec": n_chains * steps_w / max(dt, 1e-9), **row,
        })
        gamma = 0.5 / (1.0 + st.step) ** 0.6
        st = AdaptationState(
            log_sigma=st.log_sigma + gamma * (acc_rate - target_acceptance),
            step=st.step + 1, history=st.history)
    if on_card:
        guard.check("adapt_sigma_smk")
        X = klein_cuda.from_kernel_layout(kops, x)
    st.coeffs = X
    return st


def dual_averaging_update(mu: float, log_sigma: float, h_sum: float,
                          t: int, target: float, observed: float,
                          gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> Tuple[float, float, float]:
    """Nesterov dual averaging (the NUTS-style step-size adapter, applied to
    log sigma): returns (new_log_sigma, new_h_sum, log_sigma_bar_weight).

    Sign: IMHK acceptance increases with sigma, so observed < target pushes
    log sigma up (NUTS adapts a step size whose acceptance decreases in
    it, hence its `mu - ...`)."""
    h_sum = h_sum + (target - observed)
    log_sigma_new = mu + math.sqrt(t) / gamma * h_sum / (t + t0)
    eta = t ** (-kappa)
    return log_sigma_new, h_sum, eta


def estimate_burn_in_from_gap(delta: float, eps: float = 0.01,
                              cap: int = 100_000) -> int:
    """Burn-in from the spectral-gap bound t_mix < -ln(eps)/delta."""
    return int(min(math.ceil(-math.log(eps) / max(delta, 1e-12)), cap))
