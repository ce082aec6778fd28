"""q-ary lattices: LWE/SIS, Ring-LWE, Module-LWE constructions, Hermite
normal form, BKZ security estimation and the NIST parameter tables (a copy
of the JAX package's `lattices/qary.py`, which the port may not import;
only the lattice construction differs, building the port's tensor
`Lattice` on `device`, the card unless asked).

Basis construction is exact integer arithmetic on the host (numpy int64:
entries are bounded by q), then the float64 QR of `lattice_from_basis`.
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


def qary_basis(A: np.ndarray, q: int) -> np.ndarray:
    """Full-rank basis of the q-ary lattice
        L = { x in Z^n : x_head = -A x_tail  (mod q) },  n = k + m
    for A a (k, m) integer matrix mod q. Columns of the returned matrix:
        [ q I_k   -A  ]
        [   0     I_m ]
    det = q^k. (Reference qary.py:131-164 builds the same block structure.)
    """
    A = np.asarray(A, dtype=np.int64) % q
    k, m = A.shape
    B = np.zeros((k + m, k + m), dtype=np.int64)
    B[:k, :k] = q * np.eye(k, dtype=np.int64)
    B[:k, k:] = (-A) % q  # reduce mod q to keep entries small; same lattice
    B[k:, k:] = np.eye(m, dtype=np.int64)
    return B


def dual_qary_basis(A: np.ndarray, q: int) -> np.ndarray:
    """Basis of the scaled dual q-ary lattice q * L^* = { y : y = A^T s mod q }:
        [ I_k      0   ]
        [ A     q I_m  ]
    (reference qary.py:131-164 "dual basis [A | qI]")."""
    A = np.asarray(A, dtype=np.int64) % q
    k, m = A.shape
    B = np.zeros((k + m, k + m), dtype=np.int64)
    B[:k, :k] = np.eye(k, dtype=np.int64)
    B[k:, :k] = A.T
    B[k:, k:] = q * np.eye(m, dtype=np.int64)
    return B


def qary_from_matrix(A: np.ndarray, q: int, dual: bool = False,
                     dtype=torch.float64, device=None) -> Lattice:
    B = dual_qary_basis(A, q) if dual else qary_basis(A, q)
    k, m = np.asarray(A).shape
    return lattice_from_basis(
        B, name=f"qary(k={k},m={m},q={q}{',dual' if dual else ''})",
        meta={"kind": "qary", "q": q, "k": k, "m": m, "dual": dual},
        dtype=dtype, device=device)


def qary_lattice(n: int, k: int, q: int, seed: int = 0, dual: bool = False,
                 dtype=torch.float64, device=None) -> Lattice:
    """Random q-ary lattice of dimension n with det q^k
    (reference `from_random_matrix`, qary.py:78-97)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, q, size=(k, n - k), dtype=np.int64)
    return qary_from_matrix(A, q, dual=dual, dtype=dtype,
                            device=device)


def lwe_lattice(A: np.ndarray, q: int, dtype=torch.float64,
                device=None) -> Lattice:
    """Lattice from an LWE instance matrix A (k, m) mod q — the primal attack
    lattice (reference `from_lwe_instance`, qary.py:99-113)."""
    return qary_from_matrix(A, q, dual=False, dtype=dtype,
                            device=device)


def _negacyclic_rot(h: np.ndarray) -> np.ndarray:
    """Negacyclic rotation matrix: column j is x^j * h(x) mod (x^n + 1).
    Rot(h)[i, j] = h[(i - j) mod n] * (-1)^{floor((i - j)/n) ...} — i.e.
    coefficients wrap with a sign flip (reference qary.py:281-326)."""
    h = np.asarray(h, dtype=np.int64)
    n = h.shape[0]
    M = np.zeros((n, n), dtype=np.int64)
    col = h.copy()
    for j in range(n):
        M[:, j] = col
        col = np.roll(col, 1)
        col[0] = -col[0]
    return M


def rlwe_lattice(h: np.ndarray, q: int, dtype=torch.float64,
                 device=None) -> Lattice:
    """Ring-LWE ideal lattice for public polynomial h in Z_q[x]/(x^n+1):
    the 2n-dim lattice { (u, v) : u = h*v mod (q, x^n+1) } with basis
        [ q I_n   Rot(h) ]
        [   0      I_n   ]
    (reference qary.py:281-326)."""
    h = np.asarray(h, dtype=np.int64) % q
    n = h.shape[0]
    B = np.zeros((2 * n, 2 * n), dtype=np.int64)
    B[:n, :n] = q * np.eye(n, dtype=np.int64)
    B[:n, n:] = _negacyclic_rot(h) % q
    B[n:, n:] = np.eye(n, dtype=np.int64)
    return lattice_from_basis(B, name=f"rlwe(n={n},q={q})",
                              meta={"kind": "rlwe", "q": q, "ring_n": n},
                              dtype=dtype, device=device)


def module_lattice(hs: np.ndarray, q: int, dtype=torch.float64,
                   device=None) -> Lattice:
    """Module-LWE block lattice: block-diagonal stack of Ring-LWE blocks
    (reference qary.py:328-363). `hs` has shape (rank, n)."""
    hs = np.asarray(hs, dtype=np.int64)
    rank, n = hs.shape
    blocks = []
    for r in range(rank):
        Bb = np.zeros((2 * n, 2 * n), dtype=np.int64)
        Bb[:n, :n] = q * np.eye(n, dtype=np.int64)
        Bb[:n, n:] = _negacyclic_rot(hs[r]) % q
        Bb[n:, n:] = np.eye(n, dtype=np.int64)
        blocks.append(Bb)
    dim = 2 * n * rank
    B = np.zeros((dim, dim), dtype=np.int64)
    for r, Bb in enumerate(blocks):
        B[r * 2 * n:(r + 1) * 2 * n, r * 2 * n:(r + 1) * 2 * n] = Bb
    return lattice_from_basis(B, name=f"module(rank={rank},n={n},q={q})",
                              meta={"kind": "module", "q": q, "ring_n": n,
                                    "rank": rank},
                              dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Security estimation (host-side, analytic — reference qary.py:194-262).
# ---------------------------------------------------------------------------


def _root_hermite(beta: float) -> float:
    """delta_0(beta) ~ ((pi beta)^(1/beta) * beta / (2 pi e))^(1/(2(beta-1)))."""
    if beta <= 2:
        return 1.02
    return ((math.pi * beta) ** (1.0 / beta) * beta / (2 * math.pi * math.e)) ** (
        1.0 / (2.0 * (beta - 1.0)))


def estimate_bkz_security(n: int, q: int, sigma: float,
                          max_beta: int = 1000, k: Optional[int] = None,
                          log_det: Optional[float] = None) -> Dict[str, float]:
    """Core-SVP hardness of the (primal uSVP) attack against an n-dim q-ary
    lattice with error width sigma: find the smallest BKZ block size beta
    whose root-Hermite factor makes the attack succeed, then report classical
    2^{0.292 beta} and quantum 2^{0.265 beta} costs (+16.4 fudge, the
    ADPS16/BDGL16 models the reference cites at qary.py:194-262).

    The determinant is instance-aware: pass `log_det` directly, or `k` (the
    number of modular constraints, det = q^k); only with neither does it fall
    back to the balanced k = n/2 assumption.
    """
    if log_det is None:
        log_det = (n / 2 if k is None else k) * math.log(q)
    best_beta = max_beta
    for beta in range(50, max_beta):
        delta = _root_hermite(beta)
        # uSVP success condition (ADPS16): sqrt(beta) * sigma <=
        #   delta^(2 beta - n - 1) * det^(1/n)
        lhs = math.sqrt(beta) * sigma
        rhs = delta ** (2 * beta - n - 1) * math.exp(log_det / n)
        if lhs <= rhs:
            best_beta = beta
            break
    return {
        "beta": float(best_beta),
        "classical_bits": 0.292 * best_beta + 16.4,
        "quantum_bits": 0.265 * best_beta + 16.4,
        "root_hermite": _root_hermite(best_beta),
        "log2_det": log_det / math.log(2.0),
    }


def estimate_security_from_lattice(lattice, sigma: float,
                                   max_beta: int = 1000) -> Dict[str, float]:
    """Instance-aware core-SVP estimate from a concrete Lattice: the
    determinant comes from the lattice itself (meta (k, q) when present,
    otherwise sum log ||b*_i|| of the actual Gram-Schmidt profile), matching
    the reference's per-instance estimates (qary.py:194-262,450-491).

    Cross-check: an NTRU/FALCON-512 instance (dim 1024, det q^512, key
    sigma ~ 1.17 sqrt(q/2n) ~ 4.05) lands at ~108 classical bits.
    """
    n = int(lattice.n)
    meta = getattr(lattice, "meta", None) or {}
    q = int(meta.get("q", 0))
    if q and "k" in meta:
        log_det = float(meta["k"]) * math.log(q)
    elif q and meta.get("kind") in ("ntru", "rlwe"):
        # det = q^{ring_n} for [[qI, Rot(h)], [0, I]]-shaped bases
        log_det = float(meta.get("ring_n", n // 2)) * math.log(q)
    else:
        log_det = float(np.sum(np.log(
            lattice.gs_norms.detach().cpu().double().numpy())))
    return estimate_bkz_security(n, q or 2, sigma, max_beta=max_beta,
                                 log_det=log_det)


def falcon_parameters(variant: int = 512) -> Dict[str, float]:
    """FALCON parameter sets (reference qary.py:450-491)."""
    params = {
        512: {"n": 512, "q": 12289, "sigma": 165.7, "sigma_min": 1.2778,
              "security_bits": 108},
        1024: {"n": 1024, "q": 12289, "sigma": 168.4, "sigma_min": 1.2982,
               "security_bits": 252},
    }
    if variant not in params:
        raise ValueError(f"unknown FALCON variant {variant}")
    return params[variant]


def dilithium_parameters(level: int = 2) -> Dict[str, float]:
    """CRYSTALS-Dilithium parameter sets (reference qary.py:450-491)."""
    params = {
        2: {"n": 256, "q": 8380417, "k": 4, "l": 4, "eta": 2,
            "security_bits": 104},
        3: {"n": 256, "q": 8380417, "k": 6, "l": 5, "eta": 4,
            "security_bits": 138},
        5: {"n": 256, "q": 8380417, "k": 8, "l": 7, "eta": 2,
            "security_bits": 176},
    }
    if level not in params:
        raise ValueError(f"unknown Dilithium level {level}")
    return params[level]


# ---------------------------------------------------------------------------
# Hermite Normal Form (host-side exact integers — reference qary.py:403-412
# computes HNF through Sage; here it is a direct column-reduction on Python
# bigints, so no modulus/overflow constraints).
# ---------------------------------------------------------------------------


def hnf(B) -> np.ndarray:
    """Column-style Hermite Normal Form of an integer matrix.

    Returns H (lower-triangular, non-negative off-diagonals below the pivot,
    each pivot strictly dominating its row to the right... using the common
    convention: H[i, j] = 0 for j > i within the pivot structure,
    0 <= H[i, j] < H[i, i] for j < i on pivot rows) such that the columns of
    H generate the same lattice as the columns of B. Exact arithmetic via
    Python ints (arbitrary precision).
    """
    A = [[int(v) for v in row] for row in np.asarray(B)]
    n_rows = len(A)
    n_cols = len(A[0]) if n_rows else 0

    def col(j):
        return [A[i][j] for i in range(n_rows)]

    pivot_col = 0
    for i in range(n_rows):
        if pivot_col >= n_cols:
            break
        # gcd-reduce row i across columns pivot_col..end (extended Euclid by
        # repeated division keeps all entries integral and the lattice fixed)
        while True:
            nz = [j for j in range(pivot_col, n_cols) if A[i][j] != 0]
            if len(nz) <= 1:
                break
            # pick the column with the smallest nonzero |entry| as the pivot
            jmin = min(nz, key=lambda j: abs(A[i][j]))
            for j in nz:
                if j == jmin:
                    continue
                qf = A[i][j] // A[i][jmin]
                for r in range(n_rows):
                    A[r][j] -= qf * A[r][jmin]
        nz = [j for j in range(pivot_col, n_cols) if A[i][j] != 0]
        if not nz:
            continue
        j0 = nz[0]
        if j0 != pivot_col:
            for r in range(n_rows):
                A[r][j0], A[r][pivot_col] = A[r][pivot_col], A[r][j0]
        if A[i][pivot_col] < 0:
            for r in range(n_rows):
                A[r][pivot_col] = -A[r][pivot_col]
        # reduce earlier columns against this pivot so 0 <= entry < pivot
        p = A[i][pivot_col]
        for j in range(pivot_col):
            qf = A[i][j] // p
            if qf:
                for r in range(n_rows):
                    A[r][j] -= qf * A[r][pivot_col]
        pivot_col += 1

    H = np.array(A, dtype=object)
    try:
        return H.astype(np.int64)
    except OverflowError:  # keep bigints if entries exceed int64
        return H


def lattice_volume_qary(n: int, q: int, k: Optional[int] = None) -> float:
    """Analytic volume det(L) = q^k of an n-dim q-ary lattice with k modular
    constraints (reference qary.py:414-433; k defaults to n/2)."""
    if k is None:
        k = n // 2
    return float(q) ** k
