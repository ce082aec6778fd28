"""Cryptographic lattice experiments (counterpart of the JAX package's
`experiments/cryptographic.py`): sampler comparison on the lattice families
of lattice-based cryptography, sigma sensitivity on NTRU, and a JSON
checkpoint to resume the suite.

Draws and IMHK steps go through the blocked route: kernels B1 and B2 on a
card, their plain versions on the CPU. Reduction is the port's
`reduction/` (host C++). Where the JAX functions take a key, these take an
integer seed: the suite's k-th lattice runs at cfg.seed + k, whether the
run resumed or not (the JAX package folds in the count of lattices this
run evaluated, so a resumed row there draws other numbers).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
    mixing_time_bounds,
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import CryptoConfig
from lattice_gaussian_mcmc_tpu_torch.experiments.dimension_scaling import (
    checkerboard_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    identity_lattice,
    lattice_from_basis,
    ntru_lattice,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.base import smoothing_parameter
from lattice_gaussian_mcmc_tpu_torch.reduction import (
    bkz_reduce,
    lll_reduce,
    native_available,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import MAX_WINDOW
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.tools.reduction_digest import digest
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def build_lattice_suite(cfg: CryptoConfig, device=None) -> Dict[str, object]:
    """Identity / checkerboard / q-ary / NTRU suite on `device`. The q-ary
    bases up to n = 256 are LLL-reduced, and BKZ-20-reduced (4 tours) up
    to n = 128 when the native library is there; their digest is in the
    lattice's meta (`basis_digest`, `tools/reduction_digest.py`'s): at n =
    256 the LLL-reduced basis depends on the host's vector ISA (hazard
    C12)."""
    device = resolve_device(device)
    suite = {}
    n0 = cfg.qary_dims[0]
    suite[f"identity_{n0}"] = identity_lattice(n0, device=device)
    suite[f"checkerboard_{n0}"] = checkerboard_lattice(n0, device=device)
    for n in cfg.qary_dims:
        lat = qary_lattice(n, n // 2, q=cfg.qary_q, seed=cfg.seed,
                           device=device)
        if n <= 256:
            # q-ary profiles keep unit GS tails after LLL (min||b*|| = 1
            # while sigma ~ q), which overflows the 1D window; a BKZ-20
            # pass flattens the profile enough to sample at n <= 128
            B = lll_reduce(lat.basis.cpu().numpy())
            if native_available() and n <= 128:
                B = bkz_reduce(B, beta=20, max_tours=4)
                tag = "-bkz20"
            else:
                tag = "-lll"
            lat = lattice_from_basis(B, name=lat.name + tag,
                                     meta={"basis_digest": digest(B)},
                                     device=device)
        suite[f"qary_{n}"] = lat
    for n in cfg.ntru_n:
        suite[f"ntru_{n}"] = ntru_lattice(n, q=cfg.ntru_q, seed=cfg.seed,
                                          cache_dir=cfg.cache_dir,
                                          device=device)
    return suite


def suite_sigma(lat) -> float:
    """The suite's width on `lat`: max(1.2 eta, 1.05 max||b*_i||)."""
    eta = float(smoothing_parameter(lat))
    return max(1.2 * eta, 1.05 * float(torch.max(lat.gs_norms)))


def evaluate_sampler_on(lat, sigma: float, cfg: CryptoConfig,
                        seed: int) -> Dict:
    """Klein + IMHK metrics on one lattice: a blocked draw of B chains at
    `seed` (B1) and n_steps IMHK steps (one B2 launch), budgets scaled
    inversely with dimension as in the JAX package."""
    pre = klein_precompute(lat, sigma)
    digest = ({"basis_digest": lat.meta["basis_digest"]}
              if "basis_digest" in lat.meta else {})
    if pre.clamped:
        # the GS profile is too unbalanced to represent D_{Lambda,sigma}
        # at sigma >= max||b*|| within any fixed window: a truncated-law
        # row is no sampler result, and failing it would blame the sampler
        # for the instance
        return {
            "lattice": lat.name, "dimension": lat.n, "sigma": sigma,
            "window": pre.window, "window_clamped": True,
            "skipped": ("window overflow: max/min GS ratio needs a window "
                        f"> {MAX_WINDOW}; basis profile unsuitable for "
                        "lattice-Gaussian sampling at this sigma"),
            **digest,
        }
    B = min(cfg.n_chains, max(256, (1 << 20) // lat.n))
    n_steps = int(np.clip(cfg.n_samples // B, 2, max(2, 8192 // lat.n)))
    X0, lw0 = klein_sample_batch_blocked(pre, B, seed=seed)
    X, lw, acc = imhk_steps_batch_blocked(pre, X0, lw0, n_steps, seed=seed,
                                          step=1)
    delta = float(spectral_gap_mc(lw0))
    # per-coordinate law check: for sigma >= eta the coefficient covariance
    # approaches sigma^2 (B^T B)^{-1}, so mean_i emp_std_i / (sigma
    # sqrt(((B^T B)^{-1})_ii)) must sit at 1
    Bm = lat.basis.cpu().numpy().astype(np.float64)
    exp_std = sigma * np.sqrt(np.maximum(
        np.diag(np.linalg.inv(Bm.T @ Bm)), 0.0))
    emp_std = X.cpu().to(torch.float64).numpy().std(axis=0)
    std_ratio = float(np.mean(emp_std / np.maximum(exp_std, 1e-300)))
    acceptance = float(acc.to(torch.float64).mean()) / n_steps
    # gates: sigma here is >= 1.05 max||b*||, where IMHK acceptance is near
    # 1 and the covariance model holds
    passed = bool(0.85 <= std_ratio <= 1.15 and acceptance >= 0.5
                  and not pre.clamped)
    return {
        "lattice": lat.name, "dimension": lat.n, "sigma": sigma,
        "window": pre.window, "window_clamped": pre.clamped,
        "acceptance": acceptance,
        "spectral_gap": delta,
        "mixing_time_upper": mixing_time_bounds(delta)["upper"],
        "coeff_std_over_expected": std_ratio,
        "klein_is_exact_proxy": bool(delta > 0.999),
        "passed": passed,
        **digest,
    }


def run_crypto_suite(cfg: Optional[CryptoConfig] = None,
                     device=None) -> Dict:
    """Evaluate every lattice of the suite on `device` (the card unless
    asked), at sigma = max(1.2 eta, 1.05 max||b*_i||). Rows are written to
    `crypto_checkpoint.json` every `cfg.checkpoint_every` lattices; a run
    that finds the checkpoint resumes from it, and the finished suite goes
    to `crypto_results.json` (the checkpoint is then removed)."""
    cfg = cfg or CryptoConfig()
    device = resolve_device(device)
    out_dir = cfg.ensure_output()
    ckpt_path = os.path.join(out_dir, "crypto_checkpoint.json")
    done: Dict[str, Dict] = {}
    if os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            done = json.load(f)
    suite = build_lattice_suite(cfg, device)
    count = 0
    for i, (name, lat) in enumerate(suite.items()):
        if name in done:
            continue
        done[name] = evaluate_sampler_on(lat, suite_sigma(lat), cfg,
                                         cfg.seed + i)
        count += 1
        if count % cfg.checkpoint_every == 0:
            with open(ckpt_path, "w") as f:
                json.dump(done, f, indent=2, default=float)
    with open(os.path.join(out_dir, "crypto_results.json"), "w") as f:
        json.dump(done, f, indent=2, default=float)
    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    return done


def sigma_sensitivity(cfg: Optional[CryptoConfig] = None,
                      factors=(0.8, 1.0, 1.2, 1.5, 2.0),
                      device=None) -> List[Dict]:
    """Acceptance and gap vs sigma on the NTRU lattice of ring degree
    cfg.ntru_n[0]: 1,024 chains, a Klein draw and 8 IMHK steps a factor."""
    cfg = cfg or CryptoConfig()
    device = resolve_device(device)
    n = cfg.ntru_n[0]
    lat = ntru_lattice(n, q=cfg.ntru_q, seed=cfg.seed,
                       cache_dir=cfg.cache_dir, device=device)
    base = float(torch.max(lat.gs_norms))
    out = []
    for f in factors:
        sigma = f * base
        pre = klein_precompute(lat, sigma)
        X0, lw0 = klein_sample_batch_blocked(pre, 1024, seed=cfg.seed)
        _, _, acc = imhk_steps_batch_blocked(pre, X0, lw0, 8, seed=cfg.seed,
                                             step=1)
        out.append({"sigma_factor": f, "sigma": sigma,
                    "acceptance": float(acc.to(torch.float64).mean()) / 8,
                    "spectral_gap": float(spectral_gap_mc(lw0))})
    # regime gate: acceptance must be monotone-ish in sigma and near 1 at
    # the widest sigma
    accs = [r["acceptance"] for r in out]
    out.append({"gate": "sigma_monotone",
                "passed": bool(accs[-1] >= accs[0] - 0.05
                               and accs[-1] > 0.8)})
    return out
