"""Lattice as a dataclass of tensors, built once from a host float64 QR.

Counterpart of the JAX package's `lattices/base.py`. Convention: basis
columns are the lattice basis vectors; a lattice point is `basis @ x` for an
integer coefficient vector x.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.linalg import gso_qr
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


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
    Qh, Rh = gso_qr(Bh)

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

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
