"""q-ary lattices and the FALCON parameter table (the part of the JAX
package's `lattices/qary.py` that the sampling path needs)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
    Lattice,
    lattice_from_basis,
)


def qary_basis(A: np.ndarray, q: int) -> np.ndarray:
    """Full-rank basis of the q-ary lattice
        L = { x in Z^n : x_head = -A x_tail  (mod q) },  n = k + m
    for A a (k, m) integer matrix mod q. Columns of the returned matrix:
        [ q I_k   -A  ]
        [   0     I_m ]
    det = q^k."""
    A = np.asarray(A, dtype=np.int64) % q
    k, m = A.shape
    B = np.zeros((k + m, k + m), dtype=np.int64)
    B[:k, :k] = q * np.eye(k, dtype=np.int64)
    B[:k, k:] = (-A) % q
    B[k:, k:] = np.eye(m, dtype=np.int64)
    return B


def qary_lattice(n: int, k: int, q: int, seed: int = 0,
                 dtype=torch.float64, device=None) -> Lattice:
    """Random q-ary lattice of dimension n with det q^k (the same numpy draw
    as the JAX package's `qary_lattice`, so both give the same basis)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, q, size=(k, n - k), dtype=np.int64)
    return lattice_from_basis(
        qary_basis(A, q), name=f"qary(k={k},m={n - k},q={q})",
        meta={"kind": "qary", "q": q, "k": k, "m": n - k, "dual": False},
        dtype=dtype, device=device)


def falcon_parameters(variant: int = 512) -> Dict[str, float]:
    """FALCON parameter sets."""
    params = {
        512: {"n": 512, "q": 12289, "sigma": 165.7, "sigma_min": 1.2778,
              "security_bits": 108},
        1024: {"n": 1024, "q": 12289, "sigma": 168.4, "sigma_min": 1.2982,
               "security_bits": 252},
    }
    if variant not in params:
        raise ValueError(f"unknown FALCON variant {variant}")
    return params[variant]
