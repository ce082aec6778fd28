"""Convergence study (counterpart of the JAX package's
`experiments/convergence_study.py`): Klein against IMHK over a sigma grid
with enumerated ground truth, the TVD decay, the spectral-gap analysis and
dimension scaling. Chains and draws are the port's plain `imhk_chains` and
`klein_sample_batch` on the run's device (the card unless asked). Where
the JAX functions fold the study's key, these offset its seed: the Klein
batch of `compare_algorithms` at seed + 1 and its chains at seed + 2, the
gap batch of `spectral_analysis` at seed + n, that of `tvd_decay` at
seed + 9.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics import (
    effective_sample_size,
    gelman_rubin,
)
from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
    mixing_time_bounds,
    spectral_gap_mc,
    spectral_gap_theoretical,
)
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ConvergenceConfig,
)
from lattice_gaussian_mcmc_tpu_torch.experiments.klein_validation import (
    tvd_gate,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.base import smoothing_parameter
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import identity_lattice
from lattice_gaussian_mcmc_tpu_torch.reduction import lll_reduce
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import imhk_chains
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def _make_lattice(kind: str, n: int, seed: int, device=None):
    """Lattice factory: Z^n, the LLL-reduced q-ary lattice of q = 257, or
    a unit-diagonal upper-triangular skew basis."""
    if kind == "identity":
        return identity_lattice(n, device=device)
    if kind == "qary":
        lat = qary_lattice(n, n // 2, q=257, seed=seed, device="cpu")
        return lattice_from_basis(lll_reduce(lat.basis.numpy()),
                                  name=lat.name + "-lll", device=device)
    if kind == "skew":
        rng = np.random.default_rng(seed)
        B = np.triu(rng.uniform(-0.6, 0.6, (n, n))) + np.eye(n)
        np.fill_diagonal(B, 1.0)
        return lattice_from_basis(B, name=f"skew{n}", device=device)
    raise ValueError(kind)


def _ground_truth(basis: np.ndarray, sigma: float, radius: int) -> Dict:
    """Exact D_{Lambda,sigma} pmf by coefficient enumeration (n <= ~4)."""
    n = basis.shape[0]
    coords = np.array(list(itertools.product(range(-radius, radius + 1),
                                             repeat=n)), dtype=np.float64)
    pts = coords @ basis.T
    lp = -0.5 * np.sum(pts ** 2, axis=1) / sigma ** 2
    p = np.exp(lp - lp.max())
    p /= p.sum()
    return {tuple(map(int, c)): q for c, q in zip(coords, p)}


def _tvd_vs_truth(coeffs: np.ndarray, truth: Dict) -> float:
    u, c = np.unique(coeffs.astype(np.int64), axis=0, return_counts=True)
    emp = {tuple(map(int, x)): k / c.sum() for x, k in zip(u, c)}
    keys = set(emp) | set(truth)
    return 0.5 * sum(abs(emp.get(k, 0) - truth.get(k, 0)) for k in keys)


def _acceptance(states, n_chains: int) -> float:
    return float(states.accepted.sum()) / max(states.steps * n_chains, 1)


def compare_algorithms(cfg: Optional[ConvergenceConfig] = None,
                       kind: str = "skew", device=None) -> List[Dict]:
    """Klein vs IMHK TVD to the enumerated truth across the sigma grid, at
    the dimensions up to 3. IMHK (exactly stationary) is gated at every
    sigma, Klein from sigma = eta on (below, its bias from D_{Lambda,sigma}
    is real)."""
    cfg = cfg or ConvergenceConfig()
    device = resolve_device(device)
    results = []
    for n in [d for d in cfg.dimensions if d <= 3]:
        lat = _make_lattice(kind, n, cfg.seed, device)
        eta = float(smoothing_parameter(lat))
        basis = lat.basis.cpu().numpy()
        for f in cfg.sigma_factors:
            sigma = f * eta
            pre = klein_precompute(lat, sigma)
            # the enumeration box covers the law at this sigma: the spread
            # is ~sigma / min |R_ii| a coordinate
            min_r = float(torch.diagonal(lat.R).abs().min())
            radius = max(cfg.enumeration_radius,
                         int(np.ceil(5.0 * sigma / max(min_r, 1e-9))))
            truth = _ground_truth(basis, sigma, radius)
            kc, lw = klein_sample_batch(pre, cfg.n_samples, seed=cfg.seed + 1)
            ic, _, states = imhk_chains(
                pre, cfg.n_chains, cfg.n_samples // cfg.n_chains,
                burn_in=cfg.burn_in, seed=cfg.seed + 2)
            ic_flat = ic.cpu().numpy().reshape(-1, n)
            klein_tvd = _tvd_vs_truth(kc.cpu().numpy(), truth)
            imhk_tvd = _tvd_vs_truth(ic_flat, truth)
            probs = np.array(list(truth.values()))
            gate_k = tvd_gate(probs, int(kc.shape[0]))
            gate_i = tvd_gate(probs, ic_flat.shape[0])
            passed = bool(imhk_tvd <= gate_i
                          and (f < 1.0 or klein_tvd <= gate_k))
            results.append({
                "dimension": n, "sigma": sigma, "sigma_over_eta": f,
                "klein_tvd": klein_tvd,
                "imhk_tvd": imhk_tvd,
                "klein_tvd_gate": gate_k,
                "imhk_tvd_gate": gate_i,
                "passed": passed,
                "acceptance": _acceptance(states, cfg.n_chains),
                "spectral_gap_mc": float(spectral_gap_mc(lw)),
            })
    return results


def spectral_analysis(cfg: Optional[ConvergenceConfig] = None,
                      kind: str = "skew", device=None) -> List[Dict]:
    """Spectral gap (Monte Carlo and theoretical) and mixing-time bounds
    per regime."""
    cfg = cfg or ConvergenceConfig()
    device = resolve_device(device)
    out = []
    for n in cfg.dimensions:
        lat = _make_lattice(kind, n, cfg.seed, device)
        eta = float(smoothing_parameter(lat))
        for f in cfg.sigma_factors:
            pre = klein_precompute(lat, f * eta)
            _, lw = klein_sample_batch(pre, 4000, seed=cfg.seed + n)
            gap_mc = float(spectral_gap_mc(lw))
            gap_th = float(spectral_gap_theoretical(lw, pre.sigmas))
            out.append({"dimension": n, "sigma_over_eta": f,
                        "gap_mc": gap_mc, "gap_theory": gap_th,
                        "mixing": mixing_time_bounds(gap_mc)})
    return out


def tvd_decay(cfg: Optional[ConvergenceConfig] = None,
              device=None) -> List[Dict]:
    """TVD to stationarity against chain length at the configured
    checkpoints, beside the (1 - delta)^t bound; the longest prefix is
    gated (earlier ones carry the transient being measured)."""
    cfg = cfg or ConvergenceConfig()
    device = resolve_device(device)
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device=device)
    sigma = 0.35
    pre = klein_precompute(lat, sigma)
    truth = _ground_truth(basis, sigma, 10)
    coeffs, _, _ = imhk_chains(pre, cfg.n_chains, max(cfg.tvd_checkpoints),
                               seed=cfg.seed)
    _, lw = klein_sample_batch(pre, 4000, seed=cfg.seed + 9)
    delta = float(spectral_gap_mc(lw))
    flat = coeffs.cpu().numpy()
    probs = np.array(list(truth.values()))
    out = []
    for t in cfg.tvd_checkpoints:
        prefix = flat[:, :t, :].reshape(-1, 2)
        tvd = _tvd_vs_truth(prefix, truth)
        row = {"t": t, "tvd": tvd, "bound": (1 - delta) ** t}
        if t == max(cfg.tvd_checkpoints):
            row["tvd_gate"] = tvd_gate(probs, prefix.shape[0])
            row["passed"] = bool(tvd <= row["tvd_gate"])
        out.append(row)
    return out


def dimension_scaling(cfg: Optional[ConvergenceConfig] = None,
                      device=None) -> List[Dict]:
    """Acceptance, ESS per sample and R-hat against dimension, at
    sigma = 1.5 eta on the skew bases; R-hat < 1.1 is the gate."""
    cfg = cfg or ConvergenceConfig()
    device = resolve_device(device)
    out = []
    for n in cfg.dimensions:
        lat = _make_lattice("skew", n, cfg.seed, device)
        eta = float(smoothing_parameter(lat))
        pre = klein_precompute(lat, 1.5 * eta)
        T = max(cfg.n_samples // cfg.n_chains, 100)
        coeffs, _, states = imhk_chains(pre, cfg.n_chains, T,
                                        burn_in=cfg.burn_in, seed=cfg.seed)
        x0 = coeffs[:, :, 0].to(torch.float64)
        rhat = float(gelman_rubin(x0))
        out.append({
            "dimension": n,
            "acceptance": _acceptance(states, cfg.n_chains),
            "ess_per_sample": float(effective_sample_size(x0[0])) / T,
            "rhat": rhat,
            "passed": bool(rhat < 1.1),
        })
    return out


def run_study(cfg: Optional[ConvergenceConfig] = None, device=None) -> Dict:
    """The four analyses on `device`, with the gate `all_passed` over the
    algorithm comparison, the longest TVD-decay prefix and the dimension
    scaling; writes `convergence_study.json` to `cfg.output_dir`."""
    cfg = cfg or ConvergenceConfig()
    device = resolve_device(device)
    out_dir = cfg.ensure_output()
    results = {
        "algorithm_comparison": compare_algorithms(cfg, device=device),
        "spectral_analysis": spectral_analysis(cfg, device=device),
        "tvd_decay": tvd_decay(cfg, device=device),
        "dimension_scaling": dimension_scaling(cfg, device=device),
    }
    gated = (results["algorithm_comparison"]
             + [r for r in results["tvd_decay"] if "passed" in r]
             + results["dimension_scaling"])
    results["all_passed"] = bool(all(r["passed"] for r in gated))
    with open(os.path.join(out_dir, "convergence_study.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results
