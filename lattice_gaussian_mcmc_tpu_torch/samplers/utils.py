"""Discrete-Gaussian math utilities (counterpart of the JAX package's
`samplers/utils.py`): the Walker alias table, the partition function
rho_sigma(Lambda) by Monte Carlo and by bounds, the rho-inverse radius, the
coset and ellipsoidal samplers, exact 1D moments and the IMHK mixing-time
bound.

Randomness is an argument: `sample_alias` takes its uniforms, and the
Klein-based functions take an integer seed where the JAX functions take a
key. Those draw through the blocked route (`klein_sample_batch_blocked`):
kernel B1 on a card, its plain version on the CPU, on the lattice's device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
    Lattice,
    lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
)
from lattice_gaussian_mcmc_tpu_torch.ops.theta import log_rho_Z
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.stats import logmeanexp


# --- Walker alias table ----------------------------------------------------


def build_alias_table(probs, device=None) -> Dict[str, torch.Tensor]:
    """O(K) alias-table construction on the host (the JAX package's
    arithmetic, so the tables are equal), stored on `device` (the card
    unless asked): {"prob": (K,) float32, "alias": (K,) int32}."""
    p = np.asarray(probs, dtype=np.float64)
    K = len(p)
    p = p / p.sum() * K
    alias = np.zeros(K, dtype=np.int32)
    prob = np.ones(K)
    small = [i for i in range(K) if p[i] < 1.0]
    large = [i for i in range(K) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    device = resolve_device(device)
    return {"prob": torch.tensor(prob, dtype=torch.float32, device=device),
            "alias": torch.tensor(alias, dtype=torch.int32, device=device)}


def sample_alias(u_index, u_accept, table):
    """Alias-table draws from two uniforms in [0, 1) per draw (any equal
    shapes): the column floor(u_index K), kept when u_accept < its prob,
    else its alias. Returns int64 indices into the original support."""
    prob, alias = table["prob"], table["alias"]
    K = prob.shape[0]
    u_index = torch.as_tensor(u_index, device=prob.device)
    u_accept = torch.as_tensor(u_accept, device=prob.device)
    idx = torch.clamp((u_index.to(torch.float64) * K).to(torch.int64),
                      0, K - 1)
    use_alias = u_accept.to(prob.dtype) >= prob[idx]
    return torch.where(use_alias, alias[idx].to(torch.int64), idx)


# --- partition function -----------------------------------------------------


def log_partition_mc(lattice: Lattice, sigma, n_samples: int = 4096,
                     window: int = DEFAULT_WINDOW, seed: int = 0):
    """Monte-Carlo importance estimate of log rho_sigma(Lambda): Klein
    proposals' mean importance weight is exactly rho_sigma(Lambda)
    (E_q[pi~/q] = Z). One blocked Klein draw (B1 on a card)."""
    pre = klein_precompute(lattice, sigma, window=window)
    _, lw = klein_sample_batch_blocked(pre, n_samples, seed=seed)
    return logmeanexp(lw.to(torch.float64))


def log_partition_bounds(lattice: Lattice, sigma):
    """Analytic bracket: prod_i rho_{sigma/||b*_i||}(Z) upper-bounds
    rho_sigma(Lambda) (Klein normalizers at worst-case centers); the
    continuous-Gaussian volume term gives the lower bound
    (2 pi sigma^2)^{n/2} / det(Lambda). Both float64."""
    r = lattice.gs_norms.to(torch.float64)
    upper = torch.sum(log_rho_Z(float(sigma) / r))
    lower = (lattice.n / 2) * math.log(2 * math.pi * float(sigma) ** 2) \
        - lattice.log_det.to(torch.float64)
    return lower, upper


# --- rho-inverse radius search ----------------------------------------------


def rho_inverse_radius(sigma: float, target_mass: float, n: int,
                       max_radius: float = 1e6) -> float:
    """Smallest radius R with P(||x|| <= R) >= target_mass for x ~ continuous
    N(0, sigma^2 I_n): the chi quantile (the same continuous surrogate as
    the JAX package)."""
    from scipy.stats import chi
    return float(chi.ppf(target_mass, df=n, scale=sigma))


# --- coset + ellipsoidal samplers -------------------------------------------


def sample_coset(lattice: Lattice, sigma, coset_shift, num_samples: int,
                 window: Optional[int] = None, seed: int = 0):
    """Sample D_{Lambda + c, sigma}: points x in Lambda + c with probability
    ~ rho_sigma(x). Klein centred at -c, then shifted: if
    y ~ D_{Lambda, sigma, -c} then y + c ~ D_{Lambda+c, sigma}.
    Returns points (num_samples, n) in the lattice's dtype."""
    c = np.asarray(coset_shift.cpu() if isinstance(coset_shift, torch.Tensor)
                   else coset_shift, dtype=np.float64)
    pre = klein_precompute(lattice, sigma, center=-c, window=window)
    coeffs, _ = klein_sample_batch_blocked(pre, num_samples, seed=seed)
    basis = lattice.basis
    return (coeffs.to(basis.dtype) @ basis.T
            + torch.as_tensor(c, dtype=basis.dtype, device=basis.device))


def sample_ellipsoidal(lattice: Lattice, Sigma, num_samples: int,
                       window: Optional[int] = None, seed: int = 0):
    """Ellipsoidal discrete Gaussian ~ exp(-1/2 x^T Sigma^{-1} x) on Lambda:
    transform by L = chol(Sigma), sample the spherical D_{L^{-1} B, 1},
    map back with the same integer coefficients."""
    basis = lattice.basis
    Sg = torch.as_tensor(np.asarray(Sigma.cpu() if isinstance(
        Sigma, torch.Tensor) else Sigma, dtype=np.float64))
    L = torch.linalg.cholesky(Sg)
    Bt = torch.linalg.solve(L, basis.cpu().to(torch.float64))
    lat_t = lattice_from_basis(Bt, name=lattice.name + "-ellip",
                               dtype=basis.dtype, device=basis.device)
    pre = klein_precompute(lat_t, 1.0, window=window)
    coeffs, _ = klein_sample_batch_blocked(pre, num_samples, seed=seed)
    return coeffs.to(basis.dtype) @ basis.T


# --- moments & mixing bound -------------------------------------------------


def discrete_gaussian_moments(sigma, order: int = 2,
                              window: int = 4 * DEFAULT_WINDOW):
    """Exact first moments of D_{Z,sigma} by summation in float64 over
    [-window, window]."""
    k = np.arange(-window, window + 1, dtype=np.float64)
    w = np.exp(-0.5 * (k / sigma) ** 2)
    w = w / np.sum(w)
    return {m: float(np.sum(w * k ** m)) for m in range(1, order + 1)}


def imhk_mixing_time_bound(delta: float, eps: float = 0.25) -> float:
    """t_mix(eps) <= ln(1/eps)/delta (Wang-Ling exponential ergodicity)."""
    return math.log(1.0 / eps) / max(delta, 1e-300)
