"""The lattice side of the plain reference: a configuration's basis, from
a frozen NTRU key or a frozen integer basis, its float64 Gram-Schmidt
factors, and the window and width rules the samplers' laws are defined by.
Plain NumPy; nothing here imports the port.

Convention (the port's `lattice_from_basis` and `lattices/ntru.py`): the
basis columns are the basis vectors, and a lattice point is B x for an
integer vector x. An NTRU key's secret basis is
B = [[Rot(f), Rot(F)], [Rot(g), Rot(G)]], where column j of Rot(h) holds
the coefficients of x^j h mod (x^n + 1).
"""

from __future__ import annotations

import hashlib
import math
import os

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


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load_basis(path: str) -> np.ndarray:
    """A frozen integer basis as float64: an .npz holding one int64 array
    "B" of shape (d, d), columns the basis vectors. Refuses a basis that is
    not square, not integer, has an entry of magnitude 2^53 or more, or is
    singular (a diagonal entry of `gso`'s R zero to rounding)."""
    with np.load(path) as f:
        if f.files != ["B"]:
            raise ValueError(f"{path} holds {f.files}, not one array 'B'")
        B = f["B"]
    if B.ndim != 2 or B.shape[0] != B.shape[1]:
        raise ValueError(f"{path}: B has shape {B.shape}, not square")
    if B.dtype != np.int64:
        raise ValueError(f"{path}: B is {B.dtype}, not int64")
    if np.any((B >= 2 ** 53) | (B <= -2 ** 53)):     # float64 is exact below
        raise ValueError(f"{path}: B has an entry of magnitude 2^53 or more")
    Bf = B.astype(np.float64)
    r = np.abs(np.diag(gso(Bf)[1]))
    if np.any(r <= B.shape[0] * np.finfo(np.float64).eps * r.max()):
        raise ValueError(f"{path}: B is singular")
    return Bf


def basis_of(config: dict, lgbench_dir: str) -> np.ndarray:
    """The float64 basis a configuration names: exactly one of "key" (an
    NTRU key, its secret basis) and "basis" (a frozen integer basis), a
    path under `lgbench_dir` whose sha256 is "key_sha256" or
    "basis_sha256", of shape ("dimension",) * 2."""
    name = config.get("name")
    named = [k for k in ("key", "basis") if k in config]
    if len(named) != 1:
        raise ValueError(f"configuration {name!r} names {named or 'neither'}"
                         " of 'key' and 'basis', not exactly one")
    kind = named[0]
    path = os.path.join(lgbench_dir, config[kind])
    digest, want = sha256(path), config.get(f"{kind}_sha256")
    if digest != want:
        raise ValueError(f"configuration {name!r}: {config[kind]} has "
                         f"sha256 {digest}, not its {kind}_sha256 {want}")
    try:
        B = (secret_basis(load_key(path)) if kind == "key"
             else load_basis(path))
    except ValueError as e:
        raise ValueError(f"configuration {name!r}: {e}") from None
    d = config.get("dimension")
    if B.shape != (d, d):
        raise ValueError(f"configuration {name!r}: {config[kind]} gives a "
                         f"basis of shape {B.shape}, not its dimension {d}")
    return B


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
    """A width rule of a configuration: {"value": s}; {"factor": f, "eps":
    e}, f * eta_e(Z^dim) * s1(B) (Peikert's bound); or {"factor": f, "eps":
    e, "of": "gs_max"}, f * eta_e(Z^dim) * max_i ||b*_i|| (the port's
    crypto suite's width, `suite_sigma`)."""
    if "value" in rule:
        return float(rule["value"])
    n = B.shape[0]
    if "of" in rule:
        if rule["of"] != "gs_max":
            raise ValueError(f"unknown width rule of {rule['of']!r}")
        return (float(rule["factor"]) * smoothing_zn(n, float(rule["eps"]))
                * float(np.max(np.diag(gso(B)[1]))))
    return (float(rule["factor"]) * smoothing_zn(n, float(rule["eps"]))
            * float(np.linalg.norm(B, 2)))
