"""LLL / BKZ front-end: native C++ when available, pure-Python fallback
(a copy of the JAX package's `reduction/lll.py`, which the port may not
import; the library is the port's own copy of `cpp/lattice_reduce.cpp`,
built by `reduction/build.py`). Reduction runs on the host in exact
integers, as in the reference.

Parity: reference `src/lattices/reduction.py` — LLL wrapper with delta
(:68-133), manual tracked LLL (:135-186), BKZ wrapper with progressive block
sizes (:238-318). The reference shells into Sage/fplll; here the native path
is our own C++ library (cpp/lattice_reduce.cpp) loaded via ctypes, and the
Python fallback is a direct delta-LLL with floating GSO over an exact integer
basis.

Convention note: samplers use columns-as-basis-vectors; reduction operates on
rows internally. `lll_reduce`/`bkz_reduce` accept a columns-convention matrix
and handle the transpose.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from lattice_gaussian_mcmc_tpu_torch.reduction.build import load_library


def native_available() -> bool:
    return load_library() is not None


def _to_rows_int64(basis_cols: np.ndarray) -> np.ndarray:
    B = np.asarray(basis_cols)
    Bi = np.round(B).astype(np.int64)
    if not np.allclose(B, Bi, atol=1e-6):
        raise ValueError("reduction requires an (near-)integer basis")
    return np.ascontiguousarray(Bi.T)  # rows = basis vectors


def lll_reduce(basis_cols: np.ndarray, delta: float = 0.99,
               force_python: bool = False) -> np.ndarray:
    """LLL-reduce (columns convention in and out)."""
    rows = _to_rows_int64(basis_cols)
    lib = None if force_python else load_library()
    if lib is not None:
        buf = rows.copy()
        rc = lib.lll_reduce(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                            buf.shape[0], ctypes.c_double(delta))
        if rc == 0:
            return buf.T.astype(basis_cols.dtype
                                if np.issubdtype(np.asarray(basis_cols).dtype,
                                                 np.floating) else np.int64)
    reduced = lll_reduce_python(rows, delta)
    return reduced.T


def bkz_reduce(basis_cols: np.ndarray, beta: int = 20, delta: float = 0.99,
               max_tours: int = 8,
               progressive: bool = False) -> np.ndarray:
    """BKZ-reduce (columns convention). `progressive=True` ramps the block
    size 10 -> beta in steps of 10 (reference reduction.py:238-318)."""
    rows = _to_rows_int64(basis_cols)
    lib = load_library()
    if lib is None:
        # no native library: LLL is the best we can do in pure Python
        return lll_reduce_python(rows, delta).T
    buf = rows.copy()
    betas = (list(range(10, beta, 10)) + [beta]) if progressive else [beta]
    for b in betas:
        rc = lib.bkz_reduce(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                            buf.shape[0], int(b), ctypes.c_double(delta),
                            int(max_tours))
        if rc != 0:
            break
    return buf.T


def gso_profile_native(basis_cols: np.ndarray) -> Optional[np.ndarray]:
    """Exact-Gram GSO squared norms from the native library (None if
    unavailable)."""
    lib = load_library()
    if lib is None:
        return None
    rows = _to_rows_int64(basis_cols)
    out = np.zeros(rows.shape[0], dtype=np.float64)
    lib.gso_profile(rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    rows.shape[0], out.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_double)))
    return out


# ---------------------------------------------------------------------------
# Pure-Python delta-LLL (rows convention) — correctness reference + fallback.
# ---------------------------------------------------------------------------


def _gso(B: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """mu (lower unit triangular) and squared GS norms of rows of B."""
    n = B.shape[0]
    Bf = B.astype(np.float64)
    mu = np.eye(n)
    bstar = Bf.copy()
    norm2 = np.zeros(n)
    for i in range(n):
        for j in range(i):
            mu[i, j] = (Bf[i] @ bstar[j]) / norm2[j] if norm2[j] > 0 else 0.0
            bstar[i] = bstar[i] - mu[i, j] * bstar[j]
        norm2[i] = bstar[i] @ bstar[i]
    return mu, norm2


def lll_reduce_python(B_rows: np.ndarray, delta: float = 0.99) -> np.ndarray:
    """Textbook delta-LLL with exact integer rows and floating GSO
    (reference's manual tracked LLL, reduction.py:135-186). O(n) GSO
    recompute per modification keeps it simple; use the native path for
    n >~ 128."""
    B = np.array(B_rows, dtype=object)  # exact integer arithmetic
    n = B.shape[0]
    mu, norm2 = _gso(np.array(B, dtype=np.float64))
    k = 1
    iters = 0
    max_iters = 200 * n * n * max(1, n // 8)
    while k < n and iters < max_iters:
        iters += 1
        # size-reduce row k
        for j in range(k - 1, -1, -1):
            q = round(mu[k, j])
            if q != 0:
                B[k] = B[k] - q * B[j]
                mu[k, : j + 1] = mu[k, : j + 1] - q * mu[j, : j + 1]
                mu[k, j] = mu[k, j]  # updated in the slice above
        # Lovasz condition
        if norm2[k] >= (delta - mu[k, k - 1] ** 2) * norm2[k - 1]:
            k += 1
        else:
            B[[k - 1, k]] = B[[k, k - 1]]
            mu, norm2 = _gso(np.array(B, dtype=np.float64))
            k = max(k - 1, 1)
        if k < n and iters % (10 * n) == 0:
            mu, norm2 = _gso(np.array(B, dtype=np.float64))  # refresh drift
    return np.array(B, dtype=np.int64)


def is_lll_reduced(basis_cols: np.ndarray, delta: float = 0.75,
                   eta: float = 0.52) -> bool:
    """Check size-reduction + Lovasz conditions (test helper)."""
    rows = _to_rows_int64(basis_cols)
    mu, norm2 = _gso(rows.astype(np.float64))
    n = rows.shape[0]
    for i in range(n):
        for j in range(i):
            if abs(mu[i, j]) > eta:
                return False
    for k in range(1, n):
        if norm2[k] < (delta - mu[k, k - 1] ** 2) * norm2[k - 1]:
            return False
    return True
