"""Gaussian Markov random field: the precision-form Gaussian
p(x) ~ exp(-1/2 x^T Q x + b^T x) on a grid (counterpart of the JAX
package's `models/gmrf.py`). Precisions are built on the host in float64
and returned as tensors on an explicit device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.models.grid import grid_adjacency
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def gmrf_precision(shape, tau: float = 1.0, kappa: float = 0.1,
                   periodic: bool = False, dtype=torch.float64,
                   device=None) -> torch.Tensor:
    """Q = tau * (D - W) + kappa * I (graph Laplacian + nugget; SPD), on
    `device` (None: the card)."""
    W = grid_adjacency(shape, periodic)
    D = np.diag(W.sum(axis=1))
    Q = tau * (D - W) + kappa * np.eye(W.shape[0])
    return torch.as_tensor(Q, dtype=dtype).to(resolve_device(device))


def gmrf_log_density(x, Q, b=None):
    """log p(x) up to a constant: -1/2 x^T Q x + b^T x."""
    quad = -0.5 * x @ (Q @ x)
    if b is not None:
        quad = quad + b @ x
    return quad


def gmrf_grad_log_density(x, Q, b=None):
    """grad log p = -Q x + b."""
    g = -(Q @ x)
    if b is not None:
        g = g + b
    return g


def gmrf_sample(Q: torch.Tensor, b=None, shape=(),
                generator: Optional[torch.Generator] = None,
                normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact draws by the Cholesky factor of the precision:
    x = mu + L^{-T} z, Q = L L^T, mu = Q^{-1} b. The standard normals z
    (shape + (n,)) come from `generator` on Q's device, or are given as
    `normals` (the JAX package's own draws, say)."""
    n = Q.shape[0]
    L = torch.linalg.cholesky(Q)
    if normals is None:
        z = torch.randn(tuple(shape) + (n,), generator=generator,
                        dtype=Q.dtype, device=Q.device)
    else:
        z = torch.as_tensor(normals, dtype=Q.dtype).to(Q.device)
    # solve L^T x = z, the draws as columns of one right-hand side
    zf = z.reshape(-1, n).T
    x = torch.linalg.solve_triangular(L.T, zf, upper=True).T.reshape(
        tuple(shape) + (n,))
    if b is not None:
        x = x + torch.linalg.solve(Q, b)
    return x
