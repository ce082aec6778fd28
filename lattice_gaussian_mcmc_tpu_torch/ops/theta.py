"""Theta and partition-function helpers (counterpart of the JAX package's
`ops/theta.py`): the 1D partition function rho_{sigma,c}(Z) by its direct and
Poisson-summation series, Jacobi theta_3, the Z^n closed forms, the generic
smoothing-parameter bound and the enumerated Riemann theta of a small
lattice. Fixed-term series in float64 unless the inputs are tensors of
another dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_N_TERMS = 32


def _f64(x, like=None) -> torch.Tensor:
    """x as a tensor: float64 unless it is already a floating tensor (or
    `like` is)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float64)


def log_rho_Z(sigma, center=0.0):
    """log rho_{sigma,c}(Z) = log sum_{k in Z} exp(-(k - c)^2 / (2 sigma^2)):
    the direct series below sigma = 1, the Poisson-summation series
    sigma sqrt(2 pi) (1 + 2 sum_j e^{-2 pi^2 sigma^2 j^2} cos(2 pi j c))
    from there on, elementwise."""
    sigma = _f64(sigma)
    center = _f64(center, like=sigma).expand(sigma.shape)
    frac = center - torch.round(center)   # invariant to integer shifts
    k = torch.arange(-_N_TERMS, _N_TERMS + 1, dtype=sigma.dtype,
                     device=sigma.device)
    z = (k - frac[..., None]) / sigma[..., None]
    direct = torch.sum(torch.exp(-0.5 * z * z), dim=-1)
    j = torch.arange(1, 6, dtype=sigma.dtype, device=sigma.device)
    fourier = 1.0 + 2.0 * torch.sum(
        torch.exp(-2.0 * math.pi ** 2 * (sigma[..., None] * j) ** 2)
        * torch.cos(2.0 * math.pi * j * frac[..., None]), dim=-1)
    poisson = sigma * math.sqrt(2.0 * math.pi) * fourier
    return torch.log(torch.where(sigma < 1.0, direct, poisson))


def rho_Z(sigma, center=0.0):
    return torch.exp(log_rho_Z(sigma, center))


def jacobi_theta3(z, q):
    """theta_3(z, q) = 1 + 2 sum_{k>=1} q^{k^2} cos(2 k z), real nome
    0 < q < 1 (rho_{sigma,c}(Z) = theta_3(pi c, e^{-1/(2 sigma^2)}) up to
    the modular transform of `log_rho_Z`)."""
    q = _f64(q)
    z = _f64(z, like=q)
    k = torch.arange(1, _N_TERMS + 1, dtype=q.dtype, device=q.device)
    terms = q[..., None] ** (k * k) * torch.cos(2.0 * k * z[..., None])
    return 1.0 + 2.0 * torch.sum(terms, dim=-1)


def smoothing_parameter_zn(n: int, eps: float = 0.01) -> float:
    """eta_eps(Z^n) = sqrt(ln(2n(1+1/eps)) / pi)."""
    return math.sqrt(math.log(2 * n * (1 + 1 / eps)) / math.pi)


def log_partition_zn(sigma, n: int, center=None):
    """log of the Z^n partition function prod_i rho_sigma(Z - c_i)."""
    if center is None:
        return n * log_rho_Z(sigma)
    center = _f64(center)
    return torch.sum(log_rho_Z(_f64(sigma, like=center).expand(n), center))


def smoothing_parameter_generic(gs_norms, n: int, eps: float = 0.01):
    """Upper bound on eta_eps(L): sqrt(ln(2n(1+1/eps))/pi) / lambda_1(L*),
    with lambda_1(L*) >= 1 / max_i ||b*_i||."""
    return smoothing_parameter_zn(n, eps) * torch.max(_f64(gs_norms))


def log_riemann_theta(basis, sigma, center=None, radius: int = 4):
    """log Theta_L(sigma, c) = log sum_{x in L} rho_{sigma,c}(x) by
    enumerating the coefficient box [-radius, radius]^n (columns of the basis
    are the basis vectors: a point is basis @ x). Practical for n <= 8."""
    B = _f64(basis)
    n = B.shape[0]
    if (2 * radius + 1) ** n > 20_000_000:
        raise ValueError(f"enumeration box (2*{radius}+1)^{n} too large")
    grids = np.meshgrid(*([np.arange(-radius, radius + 1)] * n),
                        indexing="ij")
    coeffs = torch.as_tensor(np.stack([g.ravel() for g in grids], axis=-1),
                             dtype=B.dtype, device=B.device)
    pts = coeffs @ B.T
    if center is not None:
        pts = pts - _f64(center, like=B)
    sq = torch.sum(pts * pts, dim=-1)
    return torch.logsumexp(-0.5 * sq / _f64(sigma, like=B) ** 2, dim=0)


def riemann_theta(basis, sigma, center=None, radius: int = 4):
    return torch.exp(log_riemann_theta(basis, sigma, center, radius))
