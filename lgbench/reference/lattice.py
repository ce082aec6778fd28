"""The lattice side of the plain reference: the NTRU secret basis from a
frozen key, its float64 Gram-Schmidt factors, and the window and width
rules the samplers' laws are defined by. Plain NumPy; nothing here imports
the port.

Convention (the port's `lattices/ntru.py`): the basis columns are the
basis vectors, B = [[Rot(f), Rot(F)], [Rot(g), Rot(G)]], where column j
of Rot(h) holds the coefficients of x^j h mod (x^n + 1); a lattice point is
B x for an integer vector x.
"""

from __future__ import annotations

import math

import numpy as np


def load_key(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def rot(h) -> np.ndarray:
    """Negacyclic rotation matrix: column j = x^j h mod (x^n + 1)."""
    h = np.asarray(h, dtype=np.int64)
    n = h.shape[0]
    M = np.empty((n, n), dtype=np.int64)
    col = h.copy()
    for j in range(n):
        M[:, j] = col
        col = np.roll(col, 1)
        col[0] = -col[0]
    return M


def secret_basis(key: dict) -> np.ndarray:
    """The (2n, 2n) float64 secret basis of an NTRU key."""
    n = int(key["n"])
    B = np.zeros((2 * n, 2 * n), dtype=np.int64)
    B[:n, :n] = rot(key["f"])
    B[:n, n:] = rot(key["F"])
    B[n:, :n] = rot(key["g"])
    B[n:, n:] = rot(key["G"])
    return B.astype(np.float64)


def gso(B: np.ndarray):
    """float64 QR of the basis with R_ii > 0: b*_i = R_ii Q[:, i]."""
    Q, R = np.linalg.qr(np.asarray(B, dtype=np.float64))
    s = np.where(np.diag(R) < 0, -1.0, 1.0)
    return Q * s[None, :], R * s[:, None]


def window_budget(cond_sigmas, budget: float, max_window: int = 1024) -> int:
    """Smallest multiple-of-8 window W (support round(c) - W/2 ..
    round(c) + W/2 - 1) whose tail mass, summed over the profile of
    conditional widths, is at most `budget`: per coordinate the nearest
    omitted point lies at W/2 - 1/2 in the worst offset, and a one-sided
    tail is at most erfc(d / (s sqrt 2)) + 2 exp(-d^2 / 2 s^2) /
    (s sqrt(2 pi))."""
    s = np.maximum(np.abs(np.asarray(cond_sigmas, dtype=np.float64)), 1e-30)
    for w in range(8, max_window + 1, 8):
        d = w / 2 - 0.5
        cont = sum(math.erfc(v) for v in d / (s * math.sqrt(2.0)))
        point = np.sum(2.0 * np.exp(-0.5 * (d / s) ** 2)
                       / (s * math.sqrt(2.0 * math.pi)))
        if cont + point <= budget:
            return w
    return max_window


def smoothing_zn(n: int, eps: float) -> float:
    """eta_eps(Z^n) = sqrt(ln(2 n (1 + 1/eps)) / pi)."""
    return math.sqrt(math.log(2 * n * (1 + 1 / eps)) / math.pi)


def sigma_of(rule: dict, B: np.ndarray) -> float:
    """A width rule of a configuration: {"value": s} or {"factor": f,
    "eps": e}, the latter f * eta_e(Z^dim) * s1(B) (Peikert's bound)."""
    if "value" in rule:
        return float(rule["value"])
    n = B.shape[0]
    return (float(rule["factor"]) * smoothing_zn(n, float(rule["eps"]))
            * float(np.linalg.norm(B, 2)))
