"""Lattice linear algebra: the sign-fixed float64 host QR, Gram-Schmidt
norms and vectors, the dual basis, and Babai's nearest-plane decoding as a
plain row scan (counterpart of the JAX package's `ops/linalg.py`).

The JAX package computes the QR on the host for f32 lattices
(`lattice_gaussian_mcmc_tpu/lattices/base.py` `lattice_from_basis`); the
port always does, because the conditional widths sigma_i = sigma / R_ii
inherit R's accuracy. `babai_nearest_plane` here is the reference row scan
in the inputs' dtype (float64: the oracle); `Lattice.nearest_plane` decodes
through kernel B7 on a card.
"""

from __future__ import annotations

import numpy as np
import torch


def gso_qr(basis) -> tuple[np.ndarray, np.ndarray]:
    """QR of the basis (columns = basis vectors) in float64 with R_ii > 0.

    Gram-Schmidt vectors are b*_i = R_ii Q[:, i]; the GS norms are diag(R).
    """
    Bh = np.asarray(basis, dtype=np.float64)
    Q, R = np.linalg.qr(Bh)
    sign = np.sign(np.diag(R))
    sign[sign == 0] = 1.0
    return Q * sign[None, :], R * sign[:, None]


def _host(basis):
    """(float64 numpy copy, device of the input or CPU)."""
    if isinstance(basis, torch.Tensor):
        return basis.detach().cpu().double().numpy(), basis.device
    return np.asarray(basis, dtype=np.float64), torch.device("cpu")


def gram_schmidt_norms(basis) -> torch.Tensor:
    """||b*_i|| for all i (positive), float64 on the basis's device."""
    Bh, dev = _host(basis)
    _, R = gso_qr(Bh)
    return torch.as_tensor(np.abs(np.diag(R)), device=dev)


def gram_schmidt_vectors(basis) -> torch.Tensor:
    """The Gram-Schmidt vectors b*_i as columns, float64 on the basis's
    device."""
    Bh, dev = _host(basis)
    Q, R = gso_qr(Bh)
    return torch.as_tensor(Q * np.diag(R)[None, :], device=dev)


def dual_basis(basis) -> torch.Tensor:
    """Dual basis D with D^T B = I (the columns of inv(B)^T)."""
    return torch.linalg.inv(torch.as_tensor(basis)).T


def babai_nearest_plane(Q, R, target) -> torch.Tensor:
    """Babai's nearest plane, one row at a time for i = n-1..0:
        x_i = round((<q_i, t> - sum_{j>i} R_ij x_j) / R_ii)
    (half to even), in R's dtype. `target` is (n,) or a batch (B, n);
    returns integer-valued coefficients of the same shape."""
    t = torch.as_tensor(target).to(device=R.device, dtype=R.dtype)
    squeeze = t.ndim == 1
    t = t.reshape(-1, R.shape[0])
    cprime = t @ Q
    x = torch.zeros_like(cprime)
    for i in range(R.shape[0] - 1, -1, -1):
        s = x @ R[i]                       # x_j = 0 for j <= i
        x[:, i] = torch.round((cprime[:, i] - s) / R[i, i])
    return x[0] if squeeze else x


def decode_cvp(basis, Q, R, target):
    """Closest-plane decoding: (lattice point(s), coefficients)."""
    x = babai_nearest_plane(Q, R, target)
    return x @ basis.T, x
