"""Parameter sensitivity (counterpart of the JAX package's
`experiments/parameter_sensitivity.py`): a sigma sweep with
phase-transition detection at the smoothing parameter, basis-reduction
sensitivity and centre sensitivity.

Draws and IMHK steps go through the blocked route: kernels B1 and B2 on a
card, their plain versions on the CPU. Where the JAX functions take a key,
these take the config's seed; the sweep's cell (n, i) runs at
seed + 1000 n + i, as the JAX package folds it in.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    SensitivityConfig,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.base import smoothing_parameter
from lattice_gaussian_mcmc_tpu_torch.reduction import (
    bkz_reduce,
    lll_reduce,
    native_available,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    MAX_WINDOW,
    suggest_window,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def _test_basis(cfg: SensitivityConfig, device, n: Optional[int] = None):
    rng = np.random.default_rng(cfg.seed)
    n = n or cfg.dimension
    B = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
    np.fill_diagonal(B, 1.0)
    return lattice_from_basis(B, name=f"sens{n}", device=device)


def sigma_sweep(cfg: Optional[SensitivityConfig] = None,
                device=None) -> Dict:
    """Acceptance and spectral gap across a (sigma/eta, dimension) grid,
    2,048 chains with 8 IMHK steps a cell; detects the phase transition
    near sigma = eta."""
    cfg = cfg or SensitivityConfig()
    device = resolve_device(device)
    lo, hi = cfg.sigma_range
    factors = np.geomspace(lo, hi, cfg.sigma_grid_size)
    dims = tuple(cfg.sweep_dimensions) or (cfg.dimension,)
    rows: List[Dict] = []
    eta_by_dim = {}
    for n in dims:
        lat = _test_basis(cfg, device, n)
        eta = float(smoothing_parameter(lat))
        eta_by_dim[n] = eta
        for i, f in enumerate(factors):
            sigma = f * eta
            pre = klein_precompute(lat, sigma)
            seed = cfg.seed + 1000 * n + i
            X0, lw0 = klein_sample_batch_blocked(pre, 2048, seed=seed)
            _, _, acc = imhk_steps_batch_blocked(pre, X0, lw0, 8, seed=seed,
                                                 step=1)
            rows.append({"dimension": n, "sigma_over_eta": float(f),
                         "sigma": sigma,
                         "acceptance": float(acc.to(torch.float64).mean())
                         / 8,
                         "spectral_gap": float(spectral_gap_mc(lw0))})
    # phase transition (at the primary dimension): largest gap increase
    # between consecutive factors
    prim = [r for r in rows if r["dimension"] == dims[min(
        range(len(dims)), key=lambda j: abs(dims[j] - cfg.dimension))]]
    gaps = np.array([r["spectral_gap"] for r in prim])
    jumps = np.diff(gaps)
    transition = (float(factors[int(np.argmax(jumps)) + 1]) if len(jumps)
                  else None)
    # gate: near-full acceptance at the widest sigma and a gap that grows
    # with sigma overall
    accs = [r["acceptance"] for r in prim]
    passed = bool(len(prim) >= 2 and accs[-1] > 0.8
                  and gaps[-1] >= gaps[0] - 0.05)
    return {"rows": rows, "eta_by_dim": eta_by_dim,
            "eta": eta_by_dim[dims[0]], "phase_transition_at": transition,
            "all_passed": passed}


def reduction_sensitivity(cfg: Optional[SensitivityConfig] = None,
                          device=None) -> List[Dict]:
    """Same sigma (1.2 max||b*_i||), three bases of one q-ary lattice
    (q = 257): raw, LLL and BKZ; 1,024 Klein draws each."""
    cfg = cfg or SensitivityConfig()
    device = resolve_device(device)
    n = max(cfg.dimension, 16)
    raw = qary_lattice(n, n // 2, q=257, seed=cfg.seed, device="cpu")
    bases = {"none": raw.basis.numpy()}
    bases["lll"] = lll_reduce(bases["none"])
    if native_available() and "bkz" in cfg.reductions:
        bases["bkz"] = bkz_reduce(bases["lll"], beta=min(20, n))
    out = []
    for name, B in bases.items():
        lat = lattice_from_basis(B, name=f"qary-{name}", device=device)
        max_gs = float(torch.max(lat.gs_norms))
        sigma = 1.2 * max_gs
        window = suggest_window(float(torch.max(sigma / lat.gs_norms)))
        if window > MAX_WINDOW:
            out.append({"reduction": name, "max_gs_norm": max_gs,
                        "skipped": "window overflow (unreduced basis)"})
            continue
        pre = klein_precompute(lat, sigma)
        _, lw0 = klein_sample_batch_blocked(pre, 1024, seed=cfg.seed)
        out.append({"reduction": name, "max_gs_norm": max_gs,
                    "sigma": sigma,
                    "spectral_gap": float(spectral_gap_mc(lw0)),
                    "window": window})
    return out


def center_sensitivity(cfg: Optional[SensitivityConfig] = None,
                       device=None) -> List[Dict]:
    """Origin vs random vs deep-hole centres at 1.2 eta, 4,096 Klein draws
    each, gated on the mean distance to the centre."""
    cfg = cfg or SensitivityConfig()
    device = resolve_device(device)
    lat = _test_basis(cfg, device)
    n = cfg.dimension
    eta = float(smoothing_parameter(lat))
    rng = np.random.default_rng(cfg.seed)
    basis = lat.basis.cpu().numpy()
    centers = {
        "origin": np.zeros(n),
        "random": basis @ rng.uniform(-0.5, 0.5, n),
        "deep_hole": basis @ (0.5 * np.ones(n)),
    }
    out = []
    for mode in cfg.center_modes:
        c = centers[mode]
        pre = klein_precompute(lat, 1.2 * eta, center=c)
        X, lw = klein_sample_batch_blocked(pre, 4096, seed=cfg.seed)
        pts = X.cpu().to(torch.float64).numpy() @ basis.T
        d = np.linalg.norm(pts - c, axis=1)
        mean_d = float(d.mean())
        expected = 1.2 * eta * np.sqrt(n)
        out.append({"center": mode,
                    "mean_distance": mean_d,
                    "expected_distance": expected,
                    "spectral_gap": float(spectral_gap_mc(lw)),
                    # distance-to-centre law gate: E||x - c|| ~ sigma
                    # sqrt(n) (chi_n mean); the 25% band covers the
                    # chi-vs-sqrt(n) correction and discreteness at small n
                    "passed": bool(0.75 * expected <= mean_d
                                   <= 1.25 * expected)})
    return out


def run_sensitivity(cfg: Optional[SensitivityConfig] = None,
                    device=None) -> Dict:
    """The three analyses on `device` (the card unless asked), with the
    gate `all_passed` (the sweep's and every centre's), written to
    `parameter_sensitivity.json`."""
    cfg = cfg or SensitivityConfig()
    device = resolve_device(device)
    out_dir = cfg.ensure_output()
    results = {
        "sigma_sweep": sigma_sweep(cfg, device),
        "reduction_sensitivity": reduction_sensitivity(cfg, device),
        "center_sensitivity": center_sensitivity(cfg, device),
    }
    results["all_passed"] = bool(
        results["sigma_sweep"]["all_passed"]
        and all(r["passed"] for r in results["center_sensitivity"]))
    with open(os.path.join(out_dir, "parameter_sensitivity.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results
