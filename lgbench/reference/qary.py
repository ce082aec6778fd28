"""The lattice side of the q-ary configuration, in plain NumPy and Python
integers: the LWE matrix A, membership in the q-ary lattice
Lambda_q(A) = {x in Z^n : x_head + A x_tail = 0 (mod q)} (head the first
k coordinates, tail the other n - k), and an exact determinant. An integer
basis B (columns the basis vectors) is a basis of Lambda_q(A) exactly when
every column lies in it and |det B| = q^k, the lattice's covolume: its
columns then span a sublattice of index |det B| / q^k = 1. Nothing here
imports the port.
"""

from __future__ import annotations

import numpy as np


def lwe_matrix(n: int, k: int, q: int, seed: int) -> np.ndarray:
    """A, (k, n - k) int64 uniform on [0, q): NumPy's PCG64 at `seed`, as
    the port's `qary_lattice(n, k, q, seed)` draws it."""
    return np.random.default_rng(seed).integers(0, q, size=(k, n - k),
                                                dtype=np.int64)


def in_lattice(B, A, q: int) -> np.ndarray:
    """(d,) bool: whether each column b of the integer matrix B satisfies
    b_head + A b_tail = 0 (mod q), in Python integers."""
    B = [[int(v) for v in row] for row in np.asarray(B)]
    A = [[int(v) for v in row] for row in np.asarray(A)]
    k = len(A)
    out = []
    for j in range(len(B[0])):
        col = [row[j] for row in B]
        head, tail = col[:k], col[k:]
        out.append(all((head[i] + sum(a * t for a, t in zip(A[i], tail)))
                       % q == 0 for i in range(k)))
    return np.array(out, dtype=bool)


def exact_det(B) -> int:
    """det B of a square integer matrix, exactly: Bareiss's fraction-free
    elimination in Python integers, every division exact."""
    M = [[int(v) for v in row] for row in np.asarray(B)]
    n, sign, prev = len(M), 1, 1
    for k in range(n - 1):
        if M[k][k] == 0:
            swap = next((i for i in range(k + 1, n) if M[i][k] != 0), None)
            if swap is None:
                return 0
            M[k], M[swap] = M[swap], M[k]
            sign = -sign
        for i in range(k + 1, n):
            for j in range(k + 1, n):
                M[i][j] = (M[i][j] * M[k][k] - M[i][k] * M[k][j]) // prev
        prev = M[k][k]
    return sign * M[n - 1][n - 1]
