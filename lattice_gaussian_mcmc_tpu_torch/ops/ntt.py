"""Negacyclic number-theoretic transform mod q (host-side, exact int64).

Used by NTRU key generation for invertibility checks and h = g * f^{-1} mod q
(parity: reference `src/lattices/ntru.py:114-184` initializes polynomial rings
and 2n-th root twiddles through Sage; here it is a self-contained iterative
NTT — q must satisfy 2n | q - 1, e.g. q = 12289 supports n <= 2048).
A copy of the JAX package's `ops/ntt.py`, which the port may not import.
"""

from __future__ import annotations

import numpy as np


def _pow_mod(base: int, exp: int, mod: int) -> int:
    return pow(int(base), int(exp), int(mod))


def find_primitive_root_2n(n: int, q: int) -> int:
    """Find a primitive 2n-th root of unity mod q (psi with psi^n = -1)."""
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f"2n={2*n} must divide q-1={q-1}")
    # factor q-1 enough to test generators
    def is_primitive_2n(psi):
        if _pow_mod(psi, n, q) != q - 1:
            return False
        return True
    for g in range(2, q):
        psi = _pow_mod(g, (q - 1) // (2 * n), q)
        if is_primitive_2n(psi):
            return psi
    raise RuntimeError("no primitive 2n-th root found")


class NegacyclicNTT:
    """Precomputed negacyclic NTT over Z_q[x]/(x^n + 1)."""

    def __init__(self, n: int, q: int):
        if n & (n - 1):
            raise ValueError("n must be a power of two")
        self.n, self.q = n, q
        psi = find_primitive_root_2n(n, q)
        self.psi = psi
        self.psi_inv = _pow_mod(psi, q - 2, q)
        self.n_inv = _pow_mod(n, q - 2, q)
        # bit-reversed powers of psi for the standard iterative CT/GS NTT
        br = np.zeros(n, dtype=np.int64)
        logn = n.bit_length() - 1
        for i in range(n):
            br[i] = int(f"{i:0{logn}b}"[::-1], 2) if logn else 0
        self.psis = np.array([_pow_mod(psi, int(br[i]), q) for i in range(n)],
                             dtype=np.int64)
        self.psis_inv = np.array(
            [_pow_mod(self.psi_inv, int(br[i]), q) for i in range(n)],
            dtype=np.int64)

    def forward(self, a: np.ndarray) -> np.ndarray:
        """Cooley-Tukey decimation-in-time negacyclic NTT (in bit-reversed
        output order; consistent with `inverse`)."""
        q = self.q
        a = np.asarray(a, dtype=np.int64) % q
        a = a.copy()
        t = self.n
        m = 1
        while m < self.n:
            t >>= 1
            for i in range(m):
                j1 = 2 * i * t
                j2 = j1 + t
                S = int(self.psis[m + i])
                lo = a[j1:j2].copy()
                hi = (a[j2:j2 + t] * S) % q
                a[j1:j2] = (lo + hi) % q
                a[j2:j2 + t] = (lo - hi) % q
            m <<= 1
        return a

    def inverse(self, a: np.ndarray) -> np.ndarray:
        """Gentleman-Sande inverse negacyclic NTT."""
        q = self.q
        a = np.asarray(a, dtype=np.int64) % q
        a = a.copy()
        t = 1
        m = self.n
        while m > 1:
            j1 = 0
            h = m >> 1
            for i in range(h):
                j2 = j1 + t
                S = int(self.psis_inv[h + i])
                lo = a[j1:j2].copy()
                hi = a[j2:j2 + t].copy()
                a[j1:j2] = (lo + hi) % q
                a[j2:j2 + t] = ((lo - hi) * S) % q
                j1 += 2 * t
            t <<= 1
            m = h
        return (a * self.n_inv) % q

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """a * b mod (q, x^n + 1)."""
        fa, fb = self.forward(a), self.forward(b)
        return self.inverse((fa * fb) % self.q)

    def inv(self, a: np.ndarray) -> np.ndarray:
        """a^{-1} mod (q, x^n + 1); raises if not invertible."""
        fa = self.forward(a)
        if np.any(fa == 0):
            raise ZeroDivisionError("polynomial not invertible mod q")
        fa_inv = np.array([_pow_mod(int(v), self.q - 2, self.q) for v in fa],
                          dtype=np.int64)
        return self.inverse(fa_inv)

    def is_invertible(self, a: np.ndarray) -> bool:
        return bool(np.all(self.forward(a) != 0))
