"""Spectral-gap analysis of the IMHK chain (counterpart of the JAX package's
`diagnostics/spectral.py`): the Monte Carlo gap from Klein log-weights
(delta_hat = mean w / max w), the Wang-Ling theoretical gap, mixing-time
bounds, Lloyd's k-means state discretisation, the empirical transition
gap, and the rejection sampler's spectrum. Where the JAX function takes a
`jax.random` key, this one takes an integer seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.theta import log_rho_Z
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (  # noqa: F401
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.utils.stats import logmeanexp


def spectral_gap_theoretical(log_ws, sigmas):
    """Wang-Ling Lemma 1: delta = rho_{sigma,c}(Lambda) / prod_i
    rho_{sigma_i}(Z). The numerator is the self-normalised mean of the Klein
    weights (E_q[prod Z_i(c_i)] = rho(Lambda)); the denominator the exact
    product of 1D partition functions at integer centres."""
    lw = torch.as_tensor(log_ws).reshape(-1)
    sig = torch.as_tensor(sigmas, device=lw.device).to(torch.float64)
    log_denom = torch.sum(log_rho_Z(sig)).to(lw.dtype)
    return torch.exp(logmeanexp(lw) - log_denom)


def mixing_time_bounds(delta, eps: float = 0.25):
    """t_mix(eps) bounds from exponential ergodicity: upper -ln(eps)/delta,
    lower ~ (1/delta - 1) * ln(1/(2 eps))."""
    d = float(delta)
    if d <= 0:
        return {"lower": float("inf"), "upper": float("inf")}
    upper = -math.log(eps) / d
    lower = max(0.0, (1.0 / d - 1.0) * math.log(1.0 / (2 * eps)))
    return {"lower": lower, "upper": upper}


def _nearest(X, centers):
    d2 = torch.sum((X[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1)


def _lloyd(X, centers, iters: int):
    """Lloyd's iterations from the given initial centres; a centre with no
    points keeps its place. Returns (labels, centers)."""
    k = centers.shape[0]
    for _ in range(iters):
        labels = _nearest(X, centers)
        onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ X) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where((counts > 0)[:, None], new, centers)
    return _nearest(X, centers), centers


def kmeans_discretize(seed: int, X, k: int = 16, iters: int = 25):
    """Lloyd's k-means from k distinct points of X drawn from `seed`.
    Returns (labels, centers)."""
    X = torch.as_tensor(X)
    gen = torch.Generator(device=X.device).manual_seed(int(seed))
    idx = torch.randperm(X.shape[0], generator=gen, device=X.device)[:k]
    return _lloyd(X, X[idx], iters)


def _transition_matrix(labels, k: int):
    """Row-normalised empirical transition counts from a label chain (T,)."""
    labels = torch.as_tensor(labels)
    P = torch.zeros(k * k, dtype=torch.float64, device=labels.device)
    P.index_add_(0, labels[:-1] * k + labels[1:],
                 torch.ones(labels.shape[0] - 1, dtype=torch.float64,
                            device=labels.device))
    P = P.reshape(k, k)
    return P / torch.clamp(P.sum(dim=1, keepdim=True), min=1.0)


def _transition_gap(labels, k: int) -> float:
    P = _transition_matrix(labels, k).cpu().numpy()
    mags = np.sort(np.abs(np.linalg.eigvals(P)))[::-1]
    lam2 = mags[1] if len(mags) > 1 else 0.0
    return float(1.0 - lam2)


def empirical_transition_gap(seed: int, chain, k: int = 16):
    """Empirical spectral gap: discretise states with k-means, build the
    transition matrix, gamma = 1 - |lambda_2| (host eigenvalues of the
    k x k matrix)."""
    chain = torch.as_tensor(chain)
    if chain.ndim == 1:
        chain = chain[:, None]
    labels, _ = kmeans_discretize(seed, chain, k=k)
    return _transition_gap(labels, k)


def rejection_spectrum(omega: float):
    """Lemma 4 (Wang-Ling): the independent rejection sampler's transition
    operator has eigenvalues {1, 1 - 1/omega}."""
    return np.array([1.0, 1.0 - 1.0 / omega])


def optimal_omega(log_ws) -> float:
    """omega_0 = max_x w(x), self-normalised."""
    lw = torch.as_tensor(log_ws).reshape(-1).double().cpu().numpy()
    return float(np.exp(lw.max() - (np.logaddexp.reduce(lw)
                                     - math.log(lw.size))))


def transition_decomposition(log_ws):
    """P = G + e q^T decomposition of the IMHK kernel (Wang-Ling eq. 18) as
    summary statistics over the sampled states: the jump mass (mean
    acceptance min(1, w_j / w_i) over state i and proposal j), the
    rejection mass and the largest weight over the mean."""
    lw = torch.as_tensor(log_ws).reshape(-1)
    w = torch.exp(lw - torch.max(lw))
    acc = torch.clamp(w[None, :] / w[:, None], max=1.0)
    jump_mass = float(torch.mean(acc))
    return {
        "jump_mass": jump_mass,
        "rejection_mass": 1.0 - jump_mass,
        "max_weight_ratio": float(torch.max(w) / torch.mean(w)),
    }


def triangular_structure_analysis(P):
    """Mass above and below the diagonal of an empirical transition matrix,
    its diagonal mass and the asymmetry."""
    P = P.cpu().numpy() if isinstance(P, torch.Tensor) else np.asarray(P)
    k = P.shape[0]
    upper = float(np.triu(P, 1).sum() / k)
    lower = float(np.tril(P, -1).sum() / k)
    diag = float(np.diag(P).sum() / k)
    return {"upper_mass": upper, "lower_mass": lower, "diagonal_mass": diag,
            "asymmetry": upper - lower}
