"""Klein validation suite (counterpart of the JAX package's
`experiments/klein_validation.py`): four statistical experiments.

  Exp1: 1D D_{Z, sigma} through `sample_zn` (kernel B8 on a card) against
        the exact pmf (TVD / KL)
  Exp2: 2D Klein against the fully enumerated target
  Exp3: IMHK acceptance-rate stability per block
  Exp4: mixing time, tau_int, ESS against the theoretical t_mix

Exp2-4 run the port's plain `klein_sample_batch`, `imhk_chain` and
`imhk_chains` on the run's device, as the JAX package runs its XLA
versions. Where the JAX functions take a `jax.random` key, these take an
integer seed: experiment k of `run_suite(seed)` runs at seed + k, its
second draw (the Klein batch of the gap estimate) at seed + k + 100.
Each experiment returns a plain dict; `run_suite` writes JSON and a text
report.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics import (
    effective_sample_size,
    integrated_autocorr_time,
    kl_divergence_discrete,
    mixing_time_from_tvd,
    tvd_vs_exact,
)
from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
    mixing_time_bounds,
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import sample_zn
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import exact_pmf
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
    imhk_chain,
    imhk_chains,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

TVD_GATE = 0.02
KL_GATE = 0.05
SKEW_2D = np.array([[1.0, 0.5], [0.0, 1.0]])
SECOND_DRAW = 100      # seed offset of an experiment's second draw


def tvd_noise_floor(probs) -> float:
    """Expected TVD of a perfect sampler against `probs` per unit
    1/sqrt(n): E[TVD] ~ (1/2) sum_k sqrt(2 p_k (1-p_k) / pi) / sqrt(n)
    (normal approximation to the multinomial cell errors)."""
    p = np.asarray(probs, dtype=np.float64)
    return 0.5 * float(np.sum(np.sqrt(2.0 * p * (1.0 - p) / np.pi)))


def tvd_gate(probs, n_samples: int, base: float = TVD_GATE) -> float:
    """Sample-size-aware TVD gate: base tolerance + 2x the noise floor."""
    return base + 2.0 * tvd_noise_floor(probs) / math.sqrt(n_samples)


def experiment_1_1d(seed: int, sigma: float = 5.0, n_samples: int = 100_000,
                    device=None) -> Dict:
    """1D D_{Z,sigma} empirical vs exact pmf."""
    device = resolve_device(device)
    synchronize(device)
    t0 = time.perf_counter()
    z = sample_zn(seed, 1, sigma, shape=(n_samples,), device=device)[:, 0]
    synchronize(device)
    dt = time.perf_counter() - t0
    support, probs = exact_pmf(sigma)
    tvd = tvd_vs_exact(z, support, probs)
    kl = kl_divergence_discrete(z, support, probs)
    gate = tvd_gate(probs, n_samples)
    return {"experiment": "1d_validation", "sigma": sigma,
            "n_samples": n_samples, "tvd": tvd, "kl": kl,
            "tvd_gate": gate,
            "tvd_noise_floor": tvd_noise_floor(probs) / math.sqrt(n_samples),
            "samples_per_sec": n_samples / dt,
            "passed": bool(tvd < gate and kl < KL_GATE)}


def experiment_2_2d(seed: int, sigma: float = 2.0, n_samples: int = 50_000,
                    basis: Optional[np.ndarray] = None, radius: int = 15,
                    device=None) -> Dict:
    """2D Klein vs enumerated target on a (possibly skewed) basis."""
    if basis is None:
        basis = SKEW_2D
    device = resolve_device(device)
    lat = lattice_from_basis(basis, device=device)
    pre = klein_precompute(lat, sigma)
    synchronize(device)
    t0 = time.perf_counter()
    coeffs, _ = klein_sample_batch(pre, n_samples, seed=seed)
    synchronize(device)
    dt = time.perf_counter() - t0
    coords = np.array(list(itertools.product(range(-radius, radius + 1),
                                             repeat=2)), dtype=np.float64)
    pts = coords @ np.asarray(basis).T
    lp = -0.5 * np.sum(pts ** 2, axis=1) / sigma ** 2
    p = np.exp(lp - lp.max())
    p /= p.sum()
    target = {tuple(map(int, c)): q for c, q in zip(coords, p)}
    u, n_ = np.unique(coeffs.cpu().numpy().astype(np.int64), axis=0,
                      return_counts=True)
    emp = {tuple(map(int, x)): k / n_.sum() for x, k in zip(u, n_)}
    keys = set(emp) | set(target)
    tvd = 0.5 * sum(abs(emp.get(k, 0) - target.get(k, 0)) for k in keys)
    mask = np.array([emp.get(tuple(map(int, c)), 0.0) for c in coords])
    nz = mask > 0
    kl = float(np.sum(mask[nz] * np.log(mask[nz] / p[nz])))
    gate = tvd_gate(p, n_samples)
    return {"experiment": "2d_validation", "sigma": sigma,
            "n_samples": n_samples, "tvd": float(tvd), "kl": kl,
            "tvd_gate": gate,
            "tvd_noise_floor": tvd_noise_floor(p) / math.sqrt(n_samples),
            "samples_per_sec": n_samples / dt,
            "passed": bool(tvd < gate)}


def experiment_3_acceptance(seed: int, sigma: float = 0.35,
                            n_blocks: int = 10, block_size: int = 1000,
                            device=None) -> Dict:
    """IMHK acceptance stability across consecutive blocks of steps."""
    lat = lattice_from_basis(SKEW_2D, device=resolve_device(device))
    pre = klein_precompute(lat, sigma)
    coeffs, _, state = imhk_chain(pre, n_blocks * block_size, seed=seed)
    # per-block acceptance from the number of distinct consecutive states
    moves = np.any(np.diff(coeffs.cpu().numpy(), axis=0) != 0, axis=1)
    rates = [float(np.mean(moves[i * block_size:(i + 1) * block_size]))
             for i in range(n_blocks)]
    _, lw = klein_sample_batch(pre, 2000, seed=seed + SECOND_DRAW)
    delta = float(spectral_gap_mc(lw))
    overall = float(state.accepted.sum()) / float(state.steps)
    return {"experiment": "acceptance_stability", "sigma": sigma,
            "block_rates": rates, "overall_acceptance": overall,
            "rate_std": float(np.std(rates)), "delta_estimate": delta,
            "passed": bool(np.std(rates) < 0.05)}


def experiment_4_mixing(seed: int, sigma: float = 0.35,
                        n_samples: int = 20_000, n_chains: int = 8,
                        device=None) -> Dict:
    """Mixing time / tau_int / ESS vs the theoretical bound."""
    lat = lattice_from_basis(SKEW_2D, device=resolve_device(device))
    pre = klein_precompute(lat, sigma)
    coeffs, _, states = imhk_chains(pre, n_chains, n_samples, seed=seed)
    x0 = coeffs[:, :, 0]
    tau = float(integrated_autocorr_time(x0[0]))
    ess = float(effective_sample_size(x0[0]))
    _, lw = klein_sample_batch(pre, 4000, seed=seed + SECOND_DRAW)
    delta = float(spectral_gap_mc(lw))
    bounds = mixing_time_bounds(delta)
    # empirical mixing: TVD of growing prefixes vs the final distribution
    xs = x0[0].cpu().numpy().astype(np.int64)
    support = np.arange(xs.min(), xs.max() + 1)
    final = np.bincount(xs - xs.min(), minlength=len(support)) / len(xs)
    tvds = []
    checkpoints = [10, 30, 100, 300, 1000, 3000, 10000]
    for t in checkpoints:
        if t > len(xs):
            break
        h = np.bincount(xs[:t] - xs.min(), minlength=len(support)) / t
        tvds.append(0.5 * np.abs(h - final).sum())
    t_mix_emp = (checkpoints[mixing_time_from_tvd(np.array(tvds), 0.1)]
                 if tvds and min(tvds) < 0.1 else None)
    return {"experiment": "mixing_analysis", "sigma": sigma,
            "tau_int": tau, "ess": ess, "ess_per_sample": ess / n_samples,
            "delta": delta, "t_mix_upper_theory": bounds["upper"],
            "t_mix_empirical": t_mix_emp,
            "acceptance": float(states.accepted.sum())
            / float(states.steps * n_chains),
            "passed": bool(ess / n_samples > 0.5)}


def run_suite(seed: int = 42, output_dir: str = "results/klein_validation",
              quick: bool = False, device=None) -> Dict:
    """All four experiments on `device` (the card unless asked); writes
    JSON and a text report. `quick` cuts every sample budget by 10."""
    device = resolve_device(device)
    scale = 10 if quick else 1
    results = {
        "exp1": experiment_1_1d(seed + 1, n_samples=100_000 // scale,
                                device=device),
        "exp2": experiment_2_2d(seed + 2, n_samples=50_000 // scale,
                                device=device),
        "exp3": experiment_3_acceptance(seed + 3, block_size=1000 // scale,
                                        device=device),
        "exp4": experiment_4_mixing(seed + 4, n_samples=20_000 // scale,
                                    device=device),
    }
    results["all_passed"] = all(r["passed"] for r in results.values()
                                if isinstance(r, dict))
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "validation_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    lines = ["Klein validation suite", "=" * 40]
    for name, r in results.items():
        if isinstance(r, dict):
            lines.append(f"{name}: {'PASS' if r['passed'] else 'FAIL'} "
                         f"({r['experiment']})")
    with open(os.path.join(output_dir, "report.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return results
