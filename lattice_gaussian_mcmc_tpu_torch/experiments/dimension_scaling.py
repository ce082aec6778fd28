"""Dimension-scaling analysis (counterpart of the JAX package's
`experiments/dimension_scaling.py`): throughput, the spectral gap's 1/delta
scaling, theta products, condition-number sensitivity, parallel-chain
scaling and asymptotics, and the extra lattice families Checkerboard D_n
and Root A_n.

Every draw goes through the blocked route (`klein_sample_batch_blocked`,
`imhk_steps_batch_blocked`): kernels B1 and B2 on a card, their plain
versions on the CPU. Where the JAX functions take a key, these run at the
config's seed (an analysis's k-th draw at seed + k). Rates are host clocks
around work that ends in a synchronisation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import ScalingConfig
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    identity_lattice,
    lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
    Lattice,
    smoothing_parameter,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.theta import log_rho_Z
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    blocked_operands,
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import memory_snapshot

# the asymptotic analysis's Klein batch: B1 on a card, the JAX package's
# blocked batch on the CPU
ASYMPTOTIC_CHAINS_CARD = 65_536
ASYMPTOTIC_CHAINS_CPU = 4096
# timed calls a dimension after the first; the fit takes the fastest
ASYMPTOTIC_REPS = 3


# --- extra lattice families -------------------------------------------------


def checkerboard_lattice(n: int, dtype=torch.float64, device=None) -> Lattice:
    """D_n = {x in Z^n : sum x_i even}; basis columns e_i + e_{i+1} and a
    2 e_1 variant (det 2)."""
    B = np.zeros((n, n))
    for i in range(n - 1):
        B[i, i] = 1.0
        B[i + 1, i] = 1.0
    B[0, n - 1] = 2.0
    return lattice_from_basis(B, name=f"D_{n}", meta={"kind": "checkerboard"},
                              dtype=dtype, device=device)


def root_lattice_an(n: int, dtype=torch.float64, device=None) -> Lattice:
    """A_n root lattice embedded in n dims via the basis of simple roots
    expressed in the hyperplane coordinates (Gram = Cartan matrix)."""
    cartan = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    L = np.linalg.cholesky(cartan)
    return lattice_from_basis(L.T, name=f"A_{n}", meta={"kind": "root_an"},
                              dtype=dtype, device=device)


# --- analyses --------------------------------------------------------------


def throughput_vs_dimension(cfg: Optional[ScalingConfig] = None,
                            device=None) -> List[Dict]:
    """Klein samples/s vs n on Z^n at twice its smoothing parameter: one
    warm-up draw, then 3 timed draws of 4,096 chains."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    out = []
    B = 4096
    for n in cfg.dimensions:
        lat = identity_lattice(n, device=device)
        pre = klein_precompute(lat, 2.0 * float(smoothing_parameter(lat)))
        klein_sample_batch_blocked(pre, B, seed=cfg.seed)   # warm-up
        synchronize(device)
        t0 = time.perf_counter()
        reps = 3
        for r in range(reps):
            klein_sample_batch_blocked(pre, B, seed=cfg.seed + 1 + r)
        synchronize(device)
        dt = time.perf_counter() - t0
        out.append({"dimension": n, "samples_per_sec": B * reps / dt,
                    "sec_per_sample": dt / (B * reps)})
    return out


def inverse_delta_scaling(cfg: Optional[ScalingConfig] = None,
                          device=None) -> List[Dict]:
    """Spectral gap delta vs n on progressively skewed bases."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    out = []
    for n in [d for d in cfg.dimensions if d <= 128]:
        Bm = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
        np.fill_diagonal(Bm, 1.0)
        lat = lattice_from_basis(Bm, device=device)
        sigma = 0.45  # below eta: the regime where delta < 1
        pre = klein_precompute(lat, sigma)
        _, lw = klein_sample_batch_blocked(pre, 4096, seed=cfg.seed)
        delta = float(spectral_gap_mc(lw))
        out.append({"dimension": n, "delta": delta,
                    "inv_delta": 1.0 / max(delta, 1e-12)})
    return out


def theta_product_analysis(sigmas=(0.5, 1.0, 2.0, 4.0),
                           dims=(16, 64, 256, 1024)) -> List[Dict]:
    """Product of per-coordinate rho_sigma(Z) = Z^n partition function
    (float64)."""
    out = []
    for n in dims:
        for s in sigmas:
            lz = float(log_rho_Z(torch.tensor(s, dtype=torch.float64)))
            out.append({"dimension": n, "sigma": s,
                        "log_partition": n * lz,
                        "log_partition_per_dim": lz})
    return out


def condition_number_sensitivity(cfg: Optional[ScalingConfig] = None,
                                 device=None) -> List[Dict]:
    """Acceptance and gap vs basis condition number (n = 32, sigma 0.45:
    2,048 chains, a Klein draw and 8 IMHK steps each)."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    n = 32
    out = []
    for skew in (0.0, 0.3, 0.6, 0.9):
        rng = np.random.default_rng(cfg.seed)
        Bm = np.triu(rng.uniform(-skew, skew, (n, n))) + np.eye(n)
        np.fill_diagonal(Bm, 1.0)
        lat = lattice_from_basis(Bm, device=device)
        cond = float(np.linalg.cond(Bm))
        pre = klein_precompute(lat, 0.45)
        X0, lw0 = klein_sample_batch_blocked(pre, 2048, seed=cfg.seed)
        _, _, acc = imhk_steps_batch_blocked(pre, X0, lw0, 8, seed=cfg.seed,
                                             step=1)
        out.append({"skew": skew, "condition_number": cond,
                    "acceptance": float(acc.to(torch.float64).mean()) / 8,
                    "delta": float(spectral_gap_mc(lw0))})
    return out


def parallel_chain_scaling(cfg: Optional[ScalingConfig] = None,
                           device=None) -> List[Dict]:
    """Strong scaling over the chain-batch axis (Z^128, sigma 3): one
    warm-up and one timed draw per batch size."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    n = 128
    lat = identity_lattice(n, device=device)
    pre = klein_precompute(lat, 3.0)
    out = []
    base_rate = None
    for B in cfg.n_chains_grid:
        klein_sample_batch_blocked(pre, B, seed=cfg.seed)   # warm-up
        synchronize(device)
        t0 = time.perf_counter()
        klein_sample_batch_blocked(pre, B, seed=cfg.seed + 1)
        synchronize(device)
        dt = time.perf_counter() - t0
        rate = B / dt
        if base_rate is None:
            base_rate = rate / B
        out.append({"n_chains": B, "samples_per_sec": rate,
                    "efficiency": rate / (base_rate * B)})
    return out


def _kernel_figures(pre, device) -> Dict:
    """The route B1 takes at this n_pad and, on the tensor-core sweep, its
    kernel's resources on this card (`klein_cuda.klein_tc_resources`:
    registers and spills a thread, shared memory a block, blocks an SM).
    On the CPU the plain version runs and there are none."""
    ops = blocked_operands(pre)
    if device.type != "cuda":
        return {"n_pad": ops.n_pad, "route": "plain",
                "kernel_resources": None}
    wide = klein_cuda.wide_y(ops)
    route = klein_cuda.klein_route(ops.n_pad, ops.window, wide=wide)
    res = None
    if route == "klein_tc":
        mode = "b1_wide" if wide else "b1"
        res = klein_cuda.klein_tc_resources(ops.n_pad, ops.window, mode)
    return {"n_pad": ops.n_pad, "route": route, "kernel_resources": res}


def asymptotic_analysis(cfg: Optional[ScalingConfig] = None,
                        device=None) -> List[Dict]:
    """Asymptotic-dimension analysis: throughput, complexity fit, window
    size, B1's route and kernel resources, and the host and device memory
    profile at n in `cfg.asymptotic_dims` (512-2048 by default).

    Uses Z^n so lattice construction stays O(n) and the measurement
    isolates the sampler's own per-sample scaling. A draw is B1 at 65,536
    chains on a card (4,096 chains of its plain version on the CPU); the
    first call (operands, U's fragments) is timed apart as
    `first_call_s`, then ASYMPTOTIC_REPS calls each (`rep_times_s`), and
    the fastest sets the rate and the fit, so that load on the host
    cannot flip the exponent's sign (hazard C13)."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    on_card = device.type == "cuda"
    B = ASYMPTOTIC_CHAINS_CARD if on_card else ASYMPTOTIC_CHAINS_CPU
    out = []
    for n in cfg.asymptotic_dims:
        lat = identity_lattice(n, device=device)
        sigma = 2.0 * float(smoothing_parameter(lat))
        pre = klein_precompute(lat, sigma)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        synchronize(device)
        t0 = time.perf_counter()
        klein_sample_batch_blocked(pre, B, seed=cfg.seed)
        synchronize(device)
        first_s = time.perf_counter() - t0
        times = []
        for rep in range(ASYMPTOTIC_REPS):
            t0 = time.perf_counter()
            klein_sample_batch_blocked(pre, B, seed=cfg.seed + 1 + rep)
            synchronize(device)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        row = {"dimension": n, "sigma": sigma, "window": pre.window,
               "impl": "cuda_b1" if on_card else "plain",
               "chains": B,
               "samples_per_sec": B / dt,
               "sec_per_sample": dt / B,
               "reps": ASYMPTOTIC_REPS, "rep_times_s": times,
               "first_call_s": first_s}
        row.update(_kernel_figures(pre, device))
        row.update(memory_snapshot())
        out.append(row)
    # empirical complexity exponent: sec/sample ~ n^alpha. The gate is a
    # regression tripwire, not an asymptotic claim: alpha must stay in
    # [0.2, 2.6] at production dims (a pathology shows up as alpha > 2.6,
    # a broken timer as alpha <= 0)
    if len(out) >= 2:
        ls = np.log([r["sec_per_sample"] for r in out])
        ln = np.log([r["dimension"] for r in out])
        alpha = float(np.polyfit(ln, ls, 1)[0])
        lo_band, hi_band = ((0.2, 2.6) if max(r["dimension"] for r in out)
                            >= 512 else (0.0, 3.2))
        for r in out:
            r["complexity_exponent_fit"] = alpha
        out[-1]["complexity_gate"] = [lo_band, hi_band]
        out[-1]["passed"] = bool(lo_band <= alpha <= hi_band)
    return out


def run_scaling(cfg: Optional[ScalingConfig] = None, device=None) -> Dict:
    """Every analysis on `device` (the card unless asked), with the gate
    `all_passed` (the complexity-exponent band and every measured rate
    finite and positive), written to `dimension_scaling.json`."""
    cfg = cfg or ScalingConfig()
    device = resolve_device(device)
    out_dir = cfg.ensure_output()
    results = {
        "throughput": throughput_vs_dimension(cfg, device),
        "inverse_delta": inverse_delta_scaling(cfg, device),
        "theta_products": theta_product_analysis(),
        "condition_sensitivity": condition_number_sensitivity(cfg, device),
        "parallel_chains": parallel_chain_scaling(cfg, device),
        "asymptotics": asymptotic_analysis(cfg, device),
    }
    rates_ok = all(np.isfinite(r["samples_per_sec"]) and
                   r["samples_per_sec"] > 0
                   for r in results["throughput"] + results["asymptotics"])
    asym_gates = [r["passed"] for r in results["asymptotics"]
                  if "passed" in r]
    results["all_passed"] = bool(rates_ok and all(asym_gates))
    results["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device))
    with open(os.path.join(out_dir, "dimension_scaling.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results
