"""Conditional autoregressive (CAR) model precision (counterpart of the JAX
package's `models/car.py`): Q = tau * (I - rho * W~), W~ the
row-normalised grid adjacency, symmetrised; proper for |rho| < 1."""

from __future__ import annotations

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.models.grid import grid_adjacency
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def car_precision(shape, rho: float = 0.5, tau: float = 1.0,
                  periodic: bool = False, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    if not -1.0 < rho < 1.0:
        raise ValueError("proper CAR requires |rho| < 1")
    W = grid_adjacency(shape, periodic)
    deg = W.sum(axis=1)
    Wn = W / np.maximum(deg[:, None], 1.0)
    Q = tau * (np.eye(W.shape[0]) - rho * Wn)
    Q = 0.5 * (Q + Q.T)
    return torch.as_tensor(Q, dtype=dtype).to(resolve_device(device))
