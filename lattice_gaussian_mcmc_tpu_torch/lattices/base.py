"""Lattice as a dataclass of tensors, built once from a host float64 QR,
and its derived quantities (counterpart of the JAX package's
`lattices/base.py`).

Convention: basis columns are the lattice basis vectors; a lattice point is
`basis @ x` for an integer coefficient vector x. Babai decoding
(`nearest_plane`, `decode_cvp`) runs kernel B7 on a card and its plain
version, in the lattice's dtype, on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops import linalg as _linalg
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.linalg import gso_qr
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Lattice:
    """Fields:
      basis:    (n, n) basis matrix, columns = basis vectors.
      Q, R:     QR of basis with R_ii > 0 (b*_i = R_ii Q[:, i]).
      gs_norms: (n,) Gram-Schmidt norms ||b*_i|| = R_ii.
    """

    basis: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    gs_norms: torch.Tensor
    name: str = "lattice"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.basis.shape[0]

    @property
    def min_gs_norm(self) -> torch.Tensor:
        return torch.min(self.gs_norms)

    @property
    def max_gs_norm(self) -> torch.Tensor:
        return torch.max(self.gs_norms)

    @property
    def log_det(self) -> torch.Tensor:
        """log |det(basis)| = sum_i log ||b*_i||."""
        return torch.sum(torch.log(self.gs_norms))

    def dual_basis(self) -> torch.Tensor:
        return _linalg.dual_basis(self.basis)

    def nearest_plane(self, target) -> torch.Tensor:
        """Babai nearest-plane integer coefficients (float64) of one target
        (n,) or a batch (B, n): kernel B7 on a card (float32, centres from
        this lattice's Q and R in float64), its plain version in the
        lattice's dtype on the CPU."""
        with span("lgm.entry.nearest_plane"):
            dtype = (torch.float32 if self.R.device.type == "cuda"
                     else self.R.dtype)
            ops = klein_cuda.babai_operands(self.Q, self.R, dtype)
            t = torch.as_tensor(target).to(device=self.basis.device,
                                           dtype=torch.float64)
            x = klein_cuda.babai_coeffs(ops, t.reshape(-1, self.n))
            return x[0] if t.ndim == 1 else x

    def decode_cvp(self, target):
        """Closest-plane decoding: (lattice point(s), coefficients)."""
        x = self.nearest_plane(target)
        return x.to(self.basis.dtype) @ self.basis.T, x


def lattice_from_basis(basis, name: str = "lattice",
                       meta: Optional[Dict[str, Any]] = None,
                       dtype=torch.float64, device=None) -> Lattice:
    """Build the lattice: sign-fixed float64 QR on the host, then the
    factors as `dtype` tensors on `device` (the card unless asked)."""
    device = resolve_device(device)
    Bh = np.asarray(basis.cpu() if isinstance(basis, torch.Tensor) else basis,
                    dtype=np.float64)
    if Bh.ndim != 2 or Bh.shape[0] != Bh.shape[1]:
        raise ValueError(f"basis must be square, got {Bh.shape}")

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    with span("lgm.setup.qr"):
        Qh, Rh = gso_qr(Bh)
        return Lattice(basis=t(Bh), Q=t(Qh), R=t(Rh),
                       gs_norms=t(np.abs(np.diag(Rh))), name=name,
                       meta=dict(meta or {}))


def lattice_from_numpy(d: Dict[str, np.ndarray], dtype=torch.float64,
                       device=None, name: str = "lattice") -> Lattice:
    """A `Lattice` from the JAX object's fields as numpy arrays
    (`basis, Q, R, gs_norms`), so both packages compute on the same GSO."""
    device = resolve_device(device)

    def t(k):
        return torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)

    return Lattice(basis=t("basis"), Q=t("Q"), R=t("R"),
                   gs_norms=t("gs_norms"), name=name)


# ---------------------------------------------------------------------------
# Derived analytic quantities.
# ---------------------------------------------------------------------------


def gaussian_heuristic(lattice: Lattice) -> torch.Tensor:
    """sigma_GH = sqrt(n / (2 pi e)) det^{1/n}."""
    n = lattice.n
    return math.sqrt(n / (2 * math.pi * math.e)) * torch.exp(
        lattice.log_det / n)


def first_minimum_estimate(lattice: Lattice) -> torch.Tensor:
    """Gaussian-heuristic estimate of lambda_1."""
    n = lattice.n
    return math.sqrt(n / (2 * math.pi * math.e)) * torch.exp(
        lattice.log_det / n)


def smoothing_parameter(lattice: Lattice, eps: float = 0.01) -> torch.Tensor:
    """Upper bound on eta_eps(L) through lambda_1(L*) >= 1 / max ||b*_i||."""
    return smoothing_parameter_zn(lattice.n, eps) * lattice.max_gs_norm


def covering_radius_bound(lattice: Lattice) -> torch.Tensor:
    """Nearest-plane bound mu(L) <= (1/2) sqrt(sum ||b*_i||^2)."""
    return 0.5 * torch.sqrt(torch.sum(lattice.gs_norms ** 2))


def volume(lattice: Lattice) -> torch.Tensor:
    return torch.exp(lattice.log_det)


def is_integer_basis(basis, tol: float = 1e-9) -> bool:
    b = (basis.detach().cpu().numpy() if isinstance(basis, torch.Tensor)
         else np.asarray(basis))
    return bool(np.all(np.abs(b - np.round(b)) < tol))


def coeffs_from_points(lattice: Lattice, points, tol: float = 1e-6):
    """Integer coefficients x with basis @ x = point (a solve, then
    rounding) for one point (n,) or a batch (B, n). Returns (coeffs,
    max residual)."""
    pts = torch.as_tensor(points).to(device=lattice.basis.device,
                                     dtype=lattice.basis.dtype)
    squeeze = pts.ndim == 1
    pts = pts.reshape(-1, lattice.n)
    xi = torch.round(torch.linalg.solve(lattice.basis, pts.T).T)
    resid = torch.max(torch.abs(pts - xi @ lattice.basis.T))
    return (xi[0] if squeeze else xi), resid
