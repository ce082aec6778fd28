"""Law-level validation of the float32 kernels at production dimension:
kernels B1 (Klein draw), B2 (fused IMHK), B4 (fused SMK) and B5 (Peikert)
against an independent float64 route, on the NTRU-512 (dimension 1024) or
NTRU-1024 (dimension 2048) secret basis. The port of the JAX package's
`scripts/validate_pallas_scale.py`, with its regimes, sizes and gates.

    python -m lattice_gaussian_mcmc_tpu_torch.tools.validate_scale \
        [--n-ring 512|1024] [--device cpu] [--out DIR]

Runs on the CUDA card unless `--device cpu` is given (there the kernels'
plain versions run in float32); with no card and no `--device cpu` it
exits 2. Writes `<out>/validation_dim<2 n_ring>.json` (default
`results/torch_validation/`) and exits 1 if a gate fails.

Regimes (the script's `main`):
  smooth   sigma = FALCON's (165.7 at dimension 1024, 168.4 at 2048),
           window by the tail budget 0.01 (bench.py's policy): 131,072 B1
           draws and a 16-step B2 launch on them, against 8,192 float64
           draws and 2,048 of them advanced 16 steps;
  hard     sigma = 0.45 max ||b*_i||, the same sizes, the log-weight KS
           repeated on 3 independent seeds;
  smk      the hard sigma, proposal 0.45 sigma: one B1 start and one
           48-step B4 launch on 32,768 chains, against 1,024 float64 chains;
  peikert  sigma = 1.05 r s1(B), the window of `suggest_peikert_window`:
           4 B5 rounds of 32,768 chains against 8,192 float64 draws, and
           the analytic covariance sigma^2 (B^T B)^-1.

Gates (the script's, copied): per-coordinate moments (>= 99% of the
coordinates within 3 two-sample SE, all within 6), the log-weight law (KS
p > 0.01 and the means within 4 SE; where the law is degenerate, the
float32 noise floor 8 eps |mean|), the acceptance (within max(0.01, 4
binomial SE)), the float32 conditional-mean error (< 1e-3 sigma_i), and
>= 99% of Peikert's variances within 4 SE of the analytic ones.

The float64 side is the per-row route, which shares no code with the
kernels' plain versions: `samplers/klein.py` `klein_sample_batch`,
`samplers/imhk.py` `imhk_step` and `smk_step`, `samplers/peikert.py`
`peikert_sample_batch`, in float64 on the same device, on Philox seeds of
its own. It launches no kernel; each regime records the launches on both
sides. The kernel side goes through the entry points' wrappers
(`klein_cuda.klein_draw`, `imhk_fused`, `SMKSampler.sample_iid`,
`peikert_cuda.peikert_rounds`), whose launch counts see B1, B2, B4, B5.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the script's seeds; the float64 side adds its own offset to each
SEEDS = {"smooth": 7, "hard": 8, "smk": 9, "peikert": 11}
ORACLE_OFFSET = {"klein": 1000, "smk": 2000, "peikert": 3000}
KS_SEED_STRIDE = 1009
TAU = 4.4
TAIL_BUDGET = 0.01
HARD_SIGMA_OVER_MAX_GS = 0.45
SMK_PROPOSAL_OVER_SIGMA = 0.45
PEIKERT_SIGMA_OVER_RS1 = 1.05
PEIKERT_EPS = 0.01
COND_MEAN_CHECK = 1024
PEIKERT_ROUNDS = 4           # B5 rounds a launch on the kernel side
ORACLE_CHUNK = 2048          # chains a float64 Peikert batch


@dataclasses.dataclass
class Sizes:
    """Draws, chains and steps of each side (the script's VAL_* defaults)."""

    n_kernel: int = 131_072
    n_oracle: int = 8192
    n_steps: int = 16
    ks_seeds: int = 3
    smk_kernel: int = 32_768
    smk_oracle: int = 1024
    smk_steps: int = 48
    peikert_kernel: int = 131_072
    peikert_oracle: int = 8192

    @property
    def oracle_chains(self) -> int:
        """The float64 IMHK chains: a quarter of its draws, at least 512."""
        return max(self.n_oracle // 4, 512)


# ---------------------------------------------------------------------------
# Gates: the script's numpy comparisons, copied.
# ---------------------------------------------------------------------------


def _mean_var(X, ddof: int = 0):
    """(rows, per-column mean, per-column variance) of a numpy array, or of
    a tensor in float64 on its own device (the kernel side's 131,072 x n
    draws stay on the card)."""
    if isinstance(X, torch.Tensor):
        var, mean = torch.var_mean(X.to(torch.float64), dim=0,
                                   correction=ddof)
        return X.shape[0], mean.cpu().numpy(), var.cpu().numpy()
    return X.shape[0], X.mean(0), X.var(0, ddof=ddof)


def moment_check(Xa, Xb):
    """Per-coordinate z-scores of mean/std differences between two sample
    sets; returns gate dict."""
    na, ma, va = _mean_var(Xa)
    nb, mb, vb = _mean_var(Xb)
    se_mean = np.sqrt(va / na + vb / nb)
    z_mean = np.abs(ma - mb) / np.maximum(se_mean, 1e-12)
    # SE of the std estimate ~ std / sqrt(2(N-1)) (normal approx)
    se_std = np.sqrt(va / (2 * (na - 1)) + vb / (2 * (nb - 1)))
    z_std = np.abs(np.sqrt(va) - np.sqrt(vb)) / np.maximum(se_std, 1e-12)
    frac3_mean = float(np.mean(z_mean < 3.0))
    frac3_std = float(np.mean(z_std < 3.0))
    return {
        "frac_mean_within_3se": frac3_mean,
        "frac_std_within_3se": frac3_std,
        "max_z_mean": float(z_mean.max()),
        "max_z_std": float(z_std.max()),
        "passed": bool(frac3_mean >= 0.99 and frac3_std >= 0.99
                       and z_mean.max() < 6.0 and z_std.max() < 6.0),
    }


def ks_2sample_np(x, y):
    """Two-sample KS (numpy mirror of diagnostics.convergence.ks_2sample,
    including the small-lambda shortcut)."""
    x, y = np.sort(x), np.sort(y)
    allv = np.concatenate([x, y])
    cx = np.searchsorted(x, allv, side="right") / len(x)
    cy = np.searchsorted(y, allv, side="right") / len(y)
    D = np.max(np.abs(cx - cy))
    ne = len(x) * len(y) / (len(x) + len(y))
    lam = (np.sqrt(ne) + 0.12 + 0.11 / np.sqrt(ne)) * D
    if lam < 0.3:
        return float(D), 1.0
    k = np.arange(1, 33)
    p = 2 * np.sum((-1.0) ** (k - 1) * np.exp(-2 * (k * lam) ** 2))
    return float(D), float(min(max(p, 0.0), 1.0))


def ks_check(lw_a, lw_b):
    """Compare the float32 and float64 log-weight laws.

    In smooth regimes (every conditional sigma >= 0.8) the true log-weight
    law at dimension 1024 is degenerate to ~1e-13 (the partition functions
    are centre-insensitive by Poisson summation), far below what a float32
    sum of magnitude ~1300 can resolve (ulp ~ 1e-4). There a two-sample KS
    against float64 is meaningless; the check is that the float32 noise
    stays under the compensated-summation floor. Where the law has real
    spread (hard regime), KS applies directly."""
    out = {
        "mean_f32": float(lw_a.mean()), "mean_f64": float(lw_b.mean()),
        "std_f32": float(lw_a.std()), "std_f64": float(lw_b.std()),
    }
    eps32 = float(np.finfo(np.float32).eps)
    scale = max(abs(float(lw_b.mean())), 1.0)
    f32_floor = 8 * eps32 * scale  # compensated-summation error bound
    out["f32_noise_floor"] = f32_floor
    if float(lw_b.std()) < 4 * f32_floor:
        out["degenerate"] = True
        out["passed"] = bool(
            float(lw_a.std()) < 4 * f32_floor
            and abs(float(lw_a.mean()) - float(lw_b.mean())) < 16 * f32_floor)
        return out
    out["degenerate"] = False
    D, p = ks_2sample_np(lw_a.astype(np.float64), lw_b.astype(np.float64))
    na, nb = len(lw_a), len(lw_b)
    se = np.sqrt(lw_a.var() / na + lw_b.var() / nb)
    z_mean = abs(lw_a.mean() - lw_b.mean()) / se
    out.update({"ks_D": D, "ks_p": p, "z_mean": float(z_mean)})
    out["passed"] = bool(p > 0.01 and z_mean < 4.0)
    return out


def acceptance_check(res_kernel, res_oracle):
    """Acceptances within max(0.01, 4 binomial SE), each chain (not each
    step) one observation. The keys keep the script's names."""
    a_p, a_c = res_kernel["acceptance"], res_oracle["acceptance"]
    se = np.sqrt(a_c * (1 - a_c) / int(res_oracle["n_chains"])
                 + a_p * (1 - a_p) / int(res_kernel["n_chains"]))
    gate = max(0.01, 4.0 * se)
    return {
        "acceptance_pallas_f32": a_p, "acceptance_xla_f64": a_c,
        "abs_diff": abs(a_p - a_c), "gate": gate,
        "passed": bool(abs(a_p - a_c) < gate),
    }


def f32_cond_mean_error(U64, cs64, sig64, window, X,
                        n_check=COND_MEAN_CHECK):
    """Deterministic float32-accumulation error on the backward-substitution
    inputs c_i = cs_i - sum_{j>i} U_ij x_j, evaluated at actual draws."""
    Xs = X[:n_check].astype(np.float64)
    # c_i as the kernel computes it (full row dot; U has unit diagonal, so
    # adding x_i back removes the self term)
    C64 = cs64[None, :] - Xs @ U64.T + Xs
    C32 = (cs64.astype(np.float32)[None, :]
           - Xs.astype(np.float32) @ U64.astype(np.float32).T
           + Xs.astype(np.float32)).astype(np.float64)
    err = np.abs(C64 - C32)
    rel = err / sig64[None, :]
    return {
        "max_abs_err": float(err.max()),
        "max_err_over_sigma": float(rel.max()),
        "mean_err_over_sigma": float(rel.mean()),
        # a c-perturbation of eps*sigma_i shifts per-coordinate log-density
        # by <= eps * window/2 (Lipschitz bound on the windowed logits)
        "log_density_distortion_bound": float(rel.max() * window / 2),
        "passed": bool(rel.max() < 1e-3),
    }


# ---------------------------------------------------------------------------
# The two sides.
# ---------------------------------------------------------------------------


def launch_total() -> int:
    """Every kernel launch counted since the last reset, over B1-B8."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
        klein_cuda,
        peikert_cuda,
        smk_cuda,
        zn_cuda,
    )
    kc = klein_cuda
    return (kc.klein_draw.launches + kc.klein_draw.fp32_launches
            + kc.klein_ring.launches + kc.klein_ring.fp32_launches
            + kc.imhk_fused.launches + kc.imhk_trajectory.launches
            + kc.babai_decode.launches + kc.babai_decode.fp32_launches
            + smk_cuda.smk_steps.launches
            + peikert_cuda.peikert_rounds.launches
            + zn_cuda.sample_zn_draws.launches)


class _Side:
    """Times a side on the host clock, synchronised at both ends, and
    counts the kernel launches made inside it."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from lattice_gaussian_mcmc_tpu_torch.utils.device import synchronize
        synchronize(self.device)
        self.launches0 = launch_total()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from lattice_gaussian_mcmc_tpu_torch.utils.device import synchronize
        synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.launches = launch_total() - self.launches0


def kernel_klein_imhk(pre, n_chains: int, n_steps: int, seed: int) -> Dict:
    """B1: n_chains Klein draws on `pre`'s float32 operands (Philox step
    0), then B2: n_steps fused IMHK steps on them in one launch (steps
    1 .. n_steps); no B2 launch when n_steps is 0. On CPU operands the
    wrappers run the plain versions in float32."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda as kc
    ops = kc.kernel_operands(pre)
    guard = kc.exact_guard(ops.device)
    out = {"n_chains": n_chains, "n_steps": n_steps}
    with _Side(ops.device) as draw:
        y, lw = kc.klein_draw(ops, n_chains, seed=seed, step=0, guard=guard)
        out["klein_coeffs"] = kc.from_kernel_layout(ops, y)
        out["klein_log_w"] = lw.clone()
    out["t_klein_s"], launches = draw.seconds, draw.launches
    if n_steps:
        acc = torch.zeros_like(lw)
        with _Side(ops.device) as steps:
            kc.imhk_fused(ops, y, lw, acc, n_steps, seed=seed, step=1,
                          guard=guard)
        out["imhk_coeffs"] = kc.from_kernel_layout(ops, y)
        out["acceptance"] = float(acc.sum()) / (n_chains * n_steps)
        out["t_imhk_s"] = steps.seconds
        launches += steps.launches
    kc.check_exact(guard, "validate_scale")
    out["launches"] = launches
    return out


def oracle_klein_imhk(pre, n_draws: int, n_chains: int, n_steps: int,
                      seed: int) -> Dict:
    """The float64 route: `klein_sample_batch` (per-row) for n_draws, then
    the first n_chains advanced n_steps `imhk_step`s, on seed + 1000."""
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        ChainState,
        imhk_step,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
        klein_sample_batch,
    )
    s = seed + ORACLE_OFFSET["klein"]
    out = {"n_chains": n_chains, "n_steps": n_steps}
    with _Side(pre.device) as draw:
        X, lw = klein_sample_batch(pre, n_draws, seed=s)
    out.update(klein_coeffs=X, klein_log_w=lw, t_klein_s=draw.seconds)
    launches = draw.launches
    if n_steps:
        state = ChainState(coeffs=X[:n_chains], log_w=lw[:n_chains],
                           accepted=torch.zeros(n_chains, dtype=torch.int32,
                                                device=pre.device),
                           steps=0)
        with _Side(pre.device) as steps:
            for _ in range(n_steps):
                state = imhk_step(state, pre, seed=s)
        out["imhk_coeffs"] = state.coeffs
        out["acceptance"] = float(state.accepted.sum()) / (n_chains
                                                           * n_steps)
        out["t_imhk_s"] = steps.seconds
        launches += steps.launches
    out["launches"] = launches
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def validate_regime(name: str, lat, sigma: float, sizes: Sizes, seed: int,
                    ks_seeds: int = 1, log=print) -> Dict:
    """One Klein/IMHK regime: the window by the tail budget, B1 + B2 on
    sizes.n_kernel chains against the float64 route, the script's five
    gates, and with ks_seeds > 1 the log-weight KS on fresh draws of both
    sides at seeds seed + 1009 s."""
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
        klein_precompute,
    )
    pre = klein_precompute(lat, sigma, tau=TAU, tail_budget=TAIL_BUDGET)
    window = pre.window
    log(f"[{name}] sigma={sigma:.2f} window={window} "
        f"n_kernel={sizes.n_kernel} n_f64={sizes.n_oracle}")
    kern = kernel_klein_imhk(pre, sizes.n_kernel, sizes.n_steps, seed)
    orc = oracle_klein_imhk(pre, sizes.n_oracle, sizes.oracle_chains,
                            sizes.n_steps, seed)
    log(f"[{name}] kernels: klein {kern['t_klein_s']:.3f}s imhk "
        f"{kern['t_imhk_s']:.3f}s acc={kern['acceptance']:.4f}; f64: klein "
        f"{orc['t_klein_s']:.2f}s imhk {orc['t_imhk_s']:.2f}s "
        f"acc={orc['acceptance']:.4f}")
    n_draws = sizes.n_kernel
    out = {
        "sigma": float(sigma),
        "window": int(window),
        "window_tau": TAU,
        "window_tail_budget": TAIL_BUDGET,
        "n_kernel": n_draws, "n_f64": sizes.n_oracle,
        "n_f64_chains": sizes.oracle_chains, "n_steps": sizes.n_steps,
        "moments_klein": moment_check(kern["klein_coeffs"],
                                      orc["klein_coeffs"]),
        "moments_imhk": moment_check(kern["imhk_coeffs"],
                                     orc["imhk_coeffs"]),
        "log_weights": ks_check(_host(kern["klein_log_w"]),
                                _host(orc["klein_log_w"])),
        "acceptance": acceptance_check(kern, orc),
        "f32_cond_mean": f32_cond_mean_error(
            _host(pre.U), _host(pre.cs), _host(pre.sigmas), window,
            _host(kern["klein_coeffs"][:COND_MEAN_CHECK])),
        "kernel_klein_samples_per_sec": n_draws / kern["t_klein_s"],
        "kernel_imhk_samples_per_sec":
            n_draws * sizes.n_steps / kern["t_imhk_s"],
        "f64_klein_s": orc["t_klein_s"], "f64_imhk_s": orc["t_imhk_s"],
        "kernel_launches": kern["launches"],
        "f64_launches": orc["launches"],
    }
    del kern, orc
    if ks_seeds > 1:
        multi = [out["log_weights"]]
        for k in range(1, ks_seeds):
            s = seed + KS_SEED_STRIDE * k
            kern = kernel_klein_imhk(pre, sizes.n_kernel, 0, s)
            orc = oracle_klein_imhk(pre, sizes.n_oracle, 0, 0, s)
            ks_s = ks_check(_host(kern["klein_log_w"]),
                            _host(orc["klein_log_w"]))
            log(f"[{name}] ks seed {k}: p="
                f"{ks_s.get('ks_p', float('nan')):.4g} "
                f"passed={ks_s['passed']}")
            multi.append(ks_s)
            out["kernel_launches"] += kern["launches"]
            out["f64_launches"] += orc["launches"]
            out["f64_klein_s"] += orc["t_klein_s"]
        out["log_weights_multi_seed"] = multi
        out["log_weights_all_seeds_passed"] = bool(
            all(k["passed"] for k in multi))
        out["log_weights"] = dict(out["log_weights"],
                                  passed=out["log_weights_all_seeds_passed"])
    out["passed"] = all(out[k]["passed"] for k in
                        ("moments_klein", "moments_imhk", "log_weights",
                         "acceptance", "f32_cond_mean"))
    return out


def oracle_smk(lat, sigma: float, sigma_prop: float, window: int,
               n_chains: int, n_steps: int, seed: int) -> Dict:
    """The float64 SMK route: a per-row Klein start at the target's width
    (default window), then n_steps `smk_step`s at proposal width
    sigma_prop with `window`, on seed + 2000."""
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        ChainState,
        smk_step,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
        klein_precompute,
        klein_sample_batch,
    )
    s = seed + ORACLE_OFFSET["smk"]
    pre_t = klein_precompute(lat, sigma)
    pre_h = dataclasses.replace(
        klein_precompute(lat, sigma, window=window),
        sigmas=sigma_prop / torch.diagonal(lat.R))
    with _Side(lat.R.device) as side:
        X0, _ = klein_sample_batch(pre_t, n_chains, seed=s)
        state = ChainState(coeffs=X0, log_w=torch.zeros_like(X0[:, 0]),
                           accepted=torch.zeros(n_chains, dtype=torch.int32,
                                                device=X0.device),
                           steps=0)
        for _ in range(n_steps):
            state = smk_step(state, pre_h, lat.Q, lat.R, seed=s)
    return {"smk_coeffs": state.coeffs, "n_chains": n_chains,
            "n_steps": n_steps,
            "acceptance": float(state.accepted.sum()) / (n_chains * n_steps),
            "t_s": side.seconds, "launches": side.launches}


def validate_smk(lat, sigma: float, sizes: Sizes, seed: int,
                 log=print) -> Dict:
    """B1 start + one n_steps B4 launch (`SMKSampler.sample_iid`) at
    proposal width 0.45 sigma against the float64 `smk_step` chains:
    final-state moments and pooled acceptance. The float64 side's window
    is the script's rule (`suggest_window` over the proposal widths); B4
    takes its own (the tail budget 0.01 over them), as the Pallas kernel
    did."""
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import SMKSampler
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
        suggest_window,
    )
    sigma_prop = SMK_PROPOSAL_OVER_SIGMA * float(sigma)
    dev = lat.R.device
    sampler = SMKSampler(lat, sigma, proposal_sigma=sigma_prop, device=dev)
    # the RWM-optimal 2.38 sigma / sqrt(n) is degenerate on a discrete
    # lattice at this dimension (conditional widths ~0.01: the proposal
    # never moves); 0.45 sigma is the widest width before the acceptance
    # collapses, so the comparison exercises real MH decisions
    window = min(suggest_window(float(torch.max(sampler.pre.sigmas))), 1024)
    log(f"[smk] sigma={sigma:.2f} sigma_prop={sigma_prop:.3f} "
        f"window={window} (B4 {sampler.operands.window}) "
        f"n_kernel={sizes.smk_kernel} n_f64={sizes.smk_oracle}")
    with _Side(dev) as kside:
        X = sampler.sample_iid(seed, sizes.smk_kernel,
                               n_steps=sizes.smk_steps, return_coeffs=True)
    kern = {"acceptance": sampler.acceptance_rate,
            "n_chains": sizes.smk_kernel}
    orc = oracle_smk(lat, sigma, sigma_prop, window, sizes.smk_oracle,
                     sizes.smk_steps, seed)
    log(f"[smk] kernels {kside.seconds:.3f}s acc={kern['acceptance']:.4f}; "
        f"f64 {orc['t_s']:.2f}s acc={orc['acceptance']:.4f}")
    out = {
        "sigma": float(sigma), "sigma_prop": sigma_prop,
        "window": int(window), "kernel_window": sampler.operands.window,
        "n_kernel": sizes.smk_kernel, "n_f64": sizes.smk_oracle,
        "n_steps": sizes.smk_steps,
        "moments_smk": moment_check(X, orc["smk_coeffs"]),
        "acceptance": acceptance_check(kern, orc),
        "kernel_smk_steps_per_sec":
            sizes.smk_kernel * sizes.smk_steps / kside.seconds,
        "f64_s": orc["t_s"],
        "kernel_launches": kside.launches, "f64_launches": orc["launches"],
    }
    out["passed"] = bool(out["moments_smk"]["passed"]
                         and out["acceptance"]["passed"])
    return out


def validate_peikert(lat, sizes: Sizes, seed: int, log=print) -> Dict:
    """B5 at its minimal valid sigma 1.05 r s1(B): the kernel's pooled
    i.i.d. draws (PEIKERT_ROUNDS rounds of a launch) against the float64
    `peikert_sample_batch` law at the same window (ORACLE_CHUNK chains a
    batch) and against the analytic covariance sigma^2 (B^T B)^-1."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
    from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
        smoothing_parameter_zn,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.peikert import (
        PeikertSampler,
        peikert_sample_batch,
    )
    n = lat.n
    dev = lat.basis.device
    Bh = _host(lat.basis).astype(np.float64)
    s1 = float(np.linalg.norm(Bh, 2))
    r = float(smoothing_parameter_zn(n, PEIKERT_EPS))
    sigma = PEIKERT_SIGMA_OVER_RS1 * r * s1
    sampler = PeikertSampler(lat, sigma, r=r, device=dev)
    ops = sampler.operands
    window = ops.window
    k_rounds = PEIKERT_ROUNDS
    B = sizes.peikert_kernel // k_rounds
    log(f"[peikert] sigma={sigma:.1f} r={r:.3f} window={window} "
        f"B={B}x{k_rounds} n_f64={sizes.peikert_oracle}")
    with _Side(dev) as kside:
        ring = peikert_cuda.peikert_rounds(ops, B, k_rounds, seed=seed)
        X = peikert_cuda.ring_coeffs(ops, ring).reshape(-1, n)
    del ring
    # the sampler's float64 precomputation at the kernel's window
    pre = dataclasses.replace(sampler.pre, window=window)
    s = seed + ORACLE_OFFSET["peikert"]
    with _Side(dev) as oside:
        Xc = torch.cat([peikert_sample_batch(
            pre, min(ORACLE_CHUNK, sizes.peikert_oracle - i), seed=s,
            chain_offset=i)
            for i in range(0, sizes.peikert_oracle, ORACLE_CHUNK)])
    log(f"[peikert] kernel {kside.seconds:.3f}s, f64 {oside.seconds:.2f}s")
    target_var = sigma ** 2 * np.diag(np.linalg.inv(Bh.T @ Bh))
    _, _, var = _mean_var(X, ddof=1)
    ratio = var / target_var
    # chi^2 concentration of a variance ratio at N draws: SE ~ sqrt(2/N)
    z_var = np.abs(ratio - 1.0) / np.sqrt(2.0 / X.shape[0])
    out = {
        "sigma": sigma, "r": r, "s1": s1, "window": int(window),
        "n_kernel": int(X.shape[0]), "n_f64": int(Xc.shape[0]),
        "moments_vs_f64_oracle": moment_check(X, Xc),
        "analytic_cov": {
            "var_ratio_min": float(ratio.min()),
            "var_ratio_max": float(ratio.max()),
            "frac_within_4se": float(np.mean(z_var < 4.0)),
        },
        "kernel_s": kside.seconds, "f64_s": oside.seconds,
        "kernel_launches": kside.launches, "f64_launches": oside.launches,
    }
    out["passed"] = bool(out["moments_vs_f64_oracle"]["passed"]
                         and out["analytic_cov"]["frac_within_4se"] >= 0.99)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


REGIMES = ("smooth", "hard", "smk", "peikert")


def run_validation(lat, n_ring: int, sizes: Optional[Sizes] = None,
                   log=print, seed: int = 0) -> Dict:
    """Every regime on the lattice `lat` (float64, on the device the run
    uses; the NTRU-`n_ring` secret basis): the results dict of the JSON
    file. Regime r runs on seed SEEDS[r] + `seed` (0: the script's
    seeds)."""
    from lattice_gaussian_mcmc_tpu_torch.lattices.qary import (
        falcon_parameters,
    )
    sizes = sizes or Sizes()
    dev = lat.basis.device
    max_gs = float(torch.max(lat.gs_norms))
    sigma_smooth = falcon_parameters(1024 if n_ring >= 1024
                                     else 512)["sigma"]
    # 0.45 max ||b*||: some conditional sigmas drop below 0.5, where the
    # per-coordinate partition functions are centre-sensitive and the IMHK
    # correction has real work to do
    sigma_hard = HARD_SIGMA_OVER_MAX_GS * max_gs
    results = {"lattice": f"ntru-{n_ring} (dim {2 * n_ring})",
               "dim": 2 * n_ring, "max_gs_norm": max_gs,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else str(dev)),
               "card": card_line() if dev.type == "cuda" else None,
               "sizes": dataclasses.asdict(sizes),
               "seeds": {k: v + seed for k, v in SEEDS.items()}}
    seeds = results["seeds"]
    runs = {
        "smooth": lambda: validate_regime(
            "smooth", lat, sigma_smooth, sizes, seeds["smooth"], log=log),
        "hard": lambda: validate_regime(
            "hard", lat, sigma_hard, sizes, seeds["hard"],
            ks_seeds=sizes.ks_seeds, log=log),
        "smk": lambda: validate_smk(lat, sigma_hard, sizes, seeds["smk"],
                                    log=log),
        "peikert": lambda: validate_peikert(lat, sizes, seeds["peikert"],
                                            log=log),
    }
    for name in REGIMES:
        results[name] = runs[name]()
    results["f64_route_launches"] = sum(results[k]["f64_launches"]
                                        for k in REGIMES)
    results["all_passed"] = bool(all(results[k]["passed"] for k in REGIMES)
                                 and results["f64_route_launches"] == 0)
    results["rates_are_validation_harness_not_kernel"] = True
    results["rate_note"] = (
        "rates inside this file are the validation harness's (host clock "
        "around each call, synchronised); the kernels' own times are "
        "chip_smoke.py's kernels line")
    return results


def write_results(results: Dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"validation_dim{results['dim']}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    return path


def summary_lines(results: Dict):
    """The script's closing lines, one a regime."""
    for reg in ("smooth", "hard"):
        if reg not in results:
            continue
        r = results[reg]
        lwr = r["log_weights"]
        ks_desc = ("degenerate-ok" if lwr.get("degenerate")
                   else f"ks_p {lwr.get('ks_p', float('nan')):.3g}")
        yield (f"{reg}: {'PASS' if r['passed'] else 'FAIL'} "
               f"(moments {r['moments_klein']['frac_mean_within_3se']:.3f}, "
               f"{ks_desc}, acc diff {r['acceptance']['abs_diff']:.4f}, "
               f"f32 err/sigma "
               f"{r['f32_cond_mean']['max_err_over_sigma']:.2e})")
    if "smk" in results:
        r = results["smk"]
        yield (f"smk: {'PASS' if r['passed'] else 'FAIL'} "
               f"(moments {r['moments_smk']['frac_mean_within_3se']:.3f}, "
               f"acc diff {r['acceptance']['abs_diff']:.4f})")
    if "peikert" in results:
        r = results["peikert"]
        yield (f"peikert: {'PASS' if r['passed'] else 'FAIL'} (moments "
               f"{r['moments_vs_f64_oracle']['frac_mean_within_3se']:.3f}, "
               f"var ratio {r['analytic_cov']['var_ratio_min']:.3f}.."
               f"{r['analytic_cov']['var_ratio_max']:.3f})")
    yield f"all_passed: {results['all_passed']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lattice_gaussian_mcmc_tpu_torch.tools.validate_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-ring", type=int, default=512,
                    help="NTRU ring degree (the lattice has dimension 2n)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; the card otherwise")
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "torch_validation"))
    ap.add_argument("--seed", type=int, default=0,
                    help="added to every regime's seed (0: the script's)")
    for f in dataclasses.fields(Sizes):
        ap.add_argument("--" + f.name.replace("_", "-"), type=int,
                        default=f.default)
    args = ap.parse_args(argv)
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"validate_scale: {e}", file=sys.stderr)
        return 2
    sizes = Sizes(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Sizes)})
    build_s = None
    if dev.type == "cuda":
        # every kernel built first (one nvcc a source, all at once), so
        # that no side's time holds a build
        from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
    lat = ntru_lattice(args.n_ring, q=12289, seed=0,
                       cache_dir=os.path.join(_ROOT, "bench_cache"),
                       device=dev)

    def log(msg):
        print(msg, flush=True)

    results = run_validation(lat, args.n_ring, sizes, log=log,
                             seed=args.seed)
    results["kernel_build_s"] = build_s
    path = write_results(results, args.out)
    for line in summary_lines(results):
        log(line)
    log(f"wrote {path}")
    return 0 if results["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
