"""Convergence reporting (counterpart of the JAX package's
`diagnostics/report.py`): empirical mixing time from multi-chain max TVD,
uniform ergodicity over starting points, the minorisation constant,
importance-weight distribution and ESS, distance to the mode, Gram-Schmidt
decay against coordinate usage, the batch-means batch size and the
comprehensive report. Chains come from the port's plain `imhk_chain` and
Klein draws from `klein_sample_batch`, on the precomputation's device;
where the JAX function takes a `jax.random` key, this one takes an integer
seed (chain s of a multi-chain report runs at chain offset s).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.diagnostics.convergence import (
    _host,
    batch_means_variance,
    tvd_histogram,
)
from lattice_gaussian_mcmc_tpu_torch.diagnostics.mcmc import (
    effective_sample_size,
    integrated_autocorr_time,
    mcse,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import imhk_chain
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    KleinPrecomp,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.utils.stats import logmeanexp


def empirical_mixing_time(chains, threshold: float = 0.1,
                          n_bins: int = 32) -> int:
    """Mixing time from multi-chain max pairwise binned TVD of growing
    prefixes. chains: (C, T) scalar summaries."""
    chains = torch.as_tensor(chains)
    C, T = chains.shape
    checkpoints = [t for t in (10, 30, 100, 300, 1000, 3000, 10000, T)
                   if t <= T]
    for t in checkpoints:
        tvds = [float(tvd_histogram(chains[a, :t], chains[b, :t], n_bins))
                for a in range(C) for b in range(a + 1, C)]
        if tvds and max(tvds) < threshold:
            return t
    return T


def importance_weight_report(log_ws) -> Dict[str, float]:
    """Weight distribution and importance-sampling ESS
    ESS_w = (sum w)^2 / sum w^2."""
    lw = torch.as_tensor(log_ws).reshape(-1)
    m = torch.max(lw)
    w = torch.exp(lw - m)
    ess_w = float(torch.sum(w)) ** 2 / float(torch.sum(w * w))
    return {
        "log_w_mean": float(torch.mean(lw)),
        "log_w_std": float(torch.std(lw, correction=0)),
        "log_w_max": float(m),
        "is_ess": ess_w,
        "is_ess_fraction": ess_w / lw.numel(),
        "spectral_gap_bound": float(torch.exp(logmeanexp(lw) - m)),
    }


def minorization_constant(log_ws) -> float:
    """P(x, .) >= delta pi(.) with delta = 1/max w, estimated
    self-normalised from sampled weights."""
    lw = torch.as_tensor(log_ws).reshape(-1)
    return float(torch.exp(logmeanexp(lw) - torch.max(lw)))


def uniform_ergodicity_test(pre: KleinPrecomp, seed: int, n_starts: int = 8,
                            n_steps: int = 500) -> Dict[str, object]:
    """Chains from dispersed starting points (chain offsets 0..n_starts-1);
    uniform ergodicity means their first-coordinate distributions agree
    (max pairwise TVD small)."""
    finals = [imhk_chain(pre, n_steps, seed=seed, chain_offset=s)[0][:, 0]
              for s in range(n_starts)]
    tvds = [float(tvd_histogram(finals[a], finals[b], 32))
            for a in range(n_starts) for b in range(a + 1, n_starts)]
    return {"max_pairwise_tvd": max(tvds),
            "uniformly_ergodic": max(tvds) < 0.15}


def distance_to_mode(points, center, sigma: float) -> Dict[str, float]:
    """Distance concentration around sigma sqrt(n)."""
    pts = _host(points)
    c = _host(center)
    d = np.linalg.norm(pts - c, axis=1)
    expected = sigma * np.sqrt(pts.shape[1])
    return {"mean_distance": float(d.mean()),
            "expected_distance": float(expected),
            "relative_error": float(abs(d.mean() - expected) / expected)}


def gs_decay_correlation(coeffs, gs_norms, sigma: float) -> Dict[str, object]:
    """Gram-Schmidt decay against coordinate usage: Klein's conditional
    width at coordinate i is sigma / ||b*_i||, so the per-coordinate std of
    the sampled coefficients should track 1 / ||b*_i|| over the coordinates
    whose predicted width exceeds 0.3 (narrower ones sit on one integer)."""
    X = _host(coeffs).astype(np.float64)
    g = _host(gs_norms).astype(np.float64)
    usage = X.std(axis=0)
    predicted = sigma / g
    active = predicted > 0.3
    if active.sum() >= 3 and np.ptp(g[active]) > 0:
        corr = float(np.corrcoef(np.log(g[active]),
                                 np.log(np.maximum(usage[active],
                                                   1e-12)))[0, 1])
        pred_corr = float(np.corrcoef(predicted[active],
                                      usage[active])[0, 1])
    else:
        corr = float("nan")
        pred_corr = float("nan")
    return {
        "log_gs_vs_log_usage_corr": corr,
        "predicted_vs_observed_usage_corr": pred_corr,
        "n_active_coords": int(active.sum()),
        "gs_decay_ratio": float(g.max() / g.min()),
        "usage_profile_ok": bool(np.isnan(pred_corr) or pred_corr > 0.5),
    }


def optimal_batch_size(x, candidates=(8, 16, 32, 64, 128)) -> int:
    """Batch size nearest the tau_int heuristic b ~ T^(1/3) tau^(2/3)."""
    x = torch.as_tensor(x)
    T = x.shape[0]
    tau = float(integrated_autocorr_time(x))
    target = T ** (1 / 3) * tau ** (2 / 3)
    return int(min(candidates, key=lambda b: abs(T / b - target)))


def comprehensive_report(pre: KleinPrecomp, seed: int, n_samples: int = 5000,
                         n_chains: int = 4) -> Dict[str, object]:
    """The full report: a Klein batch at `seed`, n_chains IMHK chains at
    seed + 1 (chain offsets 0..n_chains-1), the ergodicity test at
    seed + 2."""
    Xk, lw = klein_sample_batch(pre, min(n_samples, 4096), seed=seed)
    gs_norms = pre.sigma / pre.sigmas
    chains = torch.stack([imhk_chain(pre, n_samples, seed=seed + 1,
                                     chain_offset=c)[0][:, 0]
                          for c in range(n_chains)])
    x0 = chains[0]
    return {
        "importance_weights": importance_weight_report(lw),
        "gs_decay": gs_decay_correlation(Xk, gs_norms, float(pre.sigma)),
        "minorization_delta": minorization_constant(lw),
        "empirical_mixing_time": empirical_mixing_time(chains),
        "uniform_ergodicity": uniform_ergodicity_test(pre, seed + 2),
        "ess": float(effective_sample_size(x0)),
        "tau_int": float(integrated_autocorr_time(x0)),
        "mcse": float(mcse(x0)),
        "batch_means_variance": float(batch_means_variance(x0)),
        "optimal_batch_size": optimal_batch_size(x0),
    }
