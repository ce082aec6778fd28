"""NTRU / FALCON-style lattices: exact host-side key generation (NTRUSolve)
plus device-side basis materialization.

A copy of the JAX package's `lattices/ntru.py` (which the port may not
import); only the final lattice construction differs, building the port's
tensor `Lattice`. Keys are read from the committed npz cache when present,
so the NTRU-512 flagship needs no keygen.

Capability parity: reference `src/lattices/ntru.py` — polynomial rings
(:114-147), Gaussian key sampling (:186-214), invertibility checks (:224-250),
key gen f, g, h = g/f mod q (:269-310), NTRUSolve fG - gF = q via field norms
+ xgcd (:312-378), conjugate adjoint (:380-411), negacyclic circulant basis
(:482-537), GS-norm quality vs the Ducas-Prest bound (:724-747),
`verify_basis` incl. |det| = q^n (:749-801); plus the public-basis variant of
`ntru_clean.py:115-133` ([[qI, 0], [Rot(h), I]]).

Where the reference leans on SageMath (GMP/FLINT exact arithmetic), this
module uses Python big ints with Kronecker-substitution polynomial
multiplication (packing coefficients into one big integer so CPython's
subquadratic integer multiply does the convolution) — no external CAS.

Lattice convention (columns = basis vectors):
    Lambda_h = { (u, v) in Z^2n : v = u * h  mod (q, x^n + 1) }
    secret basis  B = [[Rot(f), Rot(F)], [Rot(g), Rot(G)]],   f G - g F = q
    public basis  B = [[I, 0], [Rot(h), q I]]
Both have |det| = q^n.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
    Lattice,
    lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu_torch.ops.ntt import NegacyclicNTT

# ---------------------------------------------------------------------------
# Exact polynomial arithmetic in Z[x]/(x^n + 1) with Python big ints.
# ---------------------------------------------------------------------------


def _bitsize(f) -> int:
    return max((abs(int(c)).bit_length() for c in f), default=0)


def _polymul_negacyclic(f, g, n: int):
    """Exact f * g mod (x^n + 1) via Kronecker substitution: pack signed
    coefficients at 2^b, multiply as Python ints, unpack with balanced digits.
    """
    b = _bitsize(f) + _bitsize(g) + n.bit_length() + 2
    base = 1 << b
    half = base >> 1
    # pack (signed coefficients are fine: packing is a ring hom Z[x] -> Z)
    fv = sum(int(c) << (b * i) for i, c in enumerate(f))
    gv = sum(int(c) << (b * i) for i, c in enumerate(g))
    prod = fv * gv
    # unpack 2n-1 balanced digits
    digits = []
    carry = 0
    mask = base - 1
    v = prod
    neg = v < 0
    if neg:
        v = -v
    for _ in range(2 * n):
        d = (v & mask) + carry
        v >>= b
        if d >= half:
            d -= base
            carry = 1
        else:
            carry = 0
        digits.append(-d if neg else d)
    # negacyclic fold: c[i] - c[i + n]
    out = [digits[i] - digits[i + n] for i in range(n)]
    return out


def _galois(f):
    """f(-x): flip signs of odd coefficients."""
    return [(-c if i & 1 else c) for i, c in enumerate(f)]


def _adjoint(f):
    """f~(x) = f(1/x) mod (x^n+1): [f0, -f_{n-1}, ..., -f_1]
    (reference conjugate, ntru.py:380-411)."""
    n = len(f)
    return [f[0]] + [-f[n - i] for i in range(1, n)]


def _field_norm(f):
    """N(f) in Z[x]/(x^{n/2} + 1): with f = fe(x^2) + x fo(x^2),
    N(f) = fe^2 - x * fo^2."""
    n = len(f)
    fe, fo = f[0::2], f[1::2]
    h = n // 2
    fe2 = _polymul_negacyclic(fe, fe, h)
    fo2 = _polymul_negacyclic(fo, fo, h)
    # subtract x * fo^2 (negacyclic shift by one)
    xfo2 = [-fo2[h - 1]] + fo2[: h - 1]
    return [fe2[i] - xfo2[i] for i in range(h)]


def _lift_even(f, n: int):
    """f(x^2) in Z[x]/(x^n + 1) from f in Z[x]/(x^{n/2} + 1)."""
    out = [0] * n
    out[0::2] = f
    return out


def _poly_fft(f):
    """Float FFT of f at the odd roots of x^n = -1 (negacyclic evaluation)."""
    n = len(f)
    a = np.asarray(f, dtype=np.float64)
    # embed: evaluate at exp(i pi (2k+1)/n) == FFT of a * exp(i pi j / n)
    twist = np.exp(1j * np.pi * np.arange(n) / n)
    return np.fft.fft(a * twist)


def _poly_ifft(F):
    n = len(F)
    twist = np.exp(-1j * np.pi * np.arange(n) / n)
    return np.real(np.fft.ifft(F) * twist)


def _reduce_FG(f, g, F, G, n: int):
    """Babai-reduce (F, G) against (f, g): repeatedly subtract k*(f, g) with
    k = round((F f~ + G g~) / (f f~ + g g~)). Both operand pairs are scaled
    to ~53-bit mantissas before the float FFT (deep recursion levels have
    f, g with thousands of bits), and the quotient is re-scaled by the shift
    difference — the same ladder the reference's Sage NTRUSolve descends
    exactly (ntru.py:312-378)."""
    for _ in range(400):
        sf = max(_bitsize(f), _bitsize(g), 53) - 53
        sF = max(_bitsize(F), _bitsize(G), 53) - 53
        if sF < sf:
            sF = sf  # keep the k rescale shift non-negative
        fa = _poly_fft([int(c) >> sf for c in f])
        ga = _poly_fft([int(c) >> sf for c in g])
        denom = fa * np.conj(fa) + ga * np.conj(ga)
        Fa = _poly_fft([int(c) >> sF for c in F])
        Ga = _poly_fft([int(c) >> sF for c in G])
        with np.errstate(invalid="ignore", divide="ignore"):
            kf = (Fa * np.conj(fa) + Ga * np.conj(ga)) / denom
        k = [int(c) for c in np.round(_poly_ifft(kf))]
        if all(c == 0 for c in k):
            break
        shift = sF - sf
        kf_poly = _polymul_negacyclic(k, f, n)
        kg_poly = _polymul_negacyclic(k, g, n)
        F = [F[i] - (kf_poly[i] << shift) for i in range(n)]
        G = [G[i] - (kg_poly[i] << shift) for i in range(n)]
    return F, G


def ntru_solve(f, g, q: int) -> Tuple[list, list]:
    """Solve f G - g F = q in Z[x]/(x^n + 1) (NTRUSolve, recursive field-norm
    descent; reference ntru.py:312-378). Raises ValueError if unsolvable
    (gcd of resultants does not divide q)."""
    n = len(f)
    if n == 1:
        a, b = int(f[0]), int(g[0])
        d, u, v = _xgcd(a, b)
        if d == 0 or q % d != 0:
            raise ValueError("NTRUSolve: gcd(Res(f), Res(g)) does not divide q")
        # u a + v b = d  ->  G = u q/d, F = -v q/d gives f G - g F = q
        return [-v * (q // d)], [u * (q // d)]
    fp = _field_norm(f)
    gp = _field_norm(g)
    Fp, Gp = ntru_solve(fp, gp, q)
    # lift: F = Fp(x^2) * galois(g), G = Gp(x^2) * galois(f)
    F = _polymul_negacyclic(_lift_even(Fp, n), _galois(g), n)
    G = _polymul_negacyclic(_lift_even(Gp, n), _galois(f), n)
    F, G = _reduce_FG(f, g, F, G, n)
    return F, G


def _xgcd(a: int, b: int) -> Tuple[int, int, int]:
    """Extended gcd: returns (d, u, v) with u a + v b = d >= 0."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        qq = old_r // r
        old_r, r = r, old_r - qq * r
        old_s, s = s, old_s - qq * s
        old_t, t = t, old_t - qq * t
    if old_r < 0:
        old_r, old_s, old_t = -old_r, -old_s, -old_t
    return old_r, old_s, old_t


# ---------------------------------------------------------------------------
# Key generation.
# ---------------------------------------------------------------------------


def _sample_key_poly(rng: np.random.Generator, n: int, sigma: float,
                     ternary: bool = False) -> np.ndarray:
    """Sample a small key polynomial: discrete Gaussian of width sigma
    (reference ntru.py:186-214 via Sage DGS) or ternary +-1 coefficients
    (reference ntru_clean.py keys)."""
    if ternary:
        return rng.integers(-1, 2, size=n).astype(np.int64)
    # exact CDT on host: tail tau = 10
    half = int(math.ceil(10 * sigma)) + 1
    support = np.arange(-half, half + 1)
    p = np.exp(-0.5 * (support / sigma) ** 2)
    p /= p.sum()
    return rng.choice(support, size=n, p=p).astype(np.int64)


def ntru_keygen(n: int, q: int = 12289, seed: int = 0,
                sigma_key: Optional[float] = None, ternary: bool = False,
                max_tries: int = 64) -> Dict[str, np.ndarray]:
    """Generate an NTRU key (f, g, F, G, h) with f G - g F = q and
    h = g f^{-1} mod q (reference ntru.py:269-310). Returns int64 arrays
    (F, G coefficients of good keys are < 2^40 at FALCON sizes)."""
    if sigma_key is None:
        sigma_key = 1.17 * math.sqrt(q / (2.0 * n))  # FALCON key width
    rng = np.random.default_rng(seed)
    ntt = NegacyclicNTT(n, q)
    last_err: Optional[Exception] = None
    for _ in range(max_tries):
        f = _sample_key_poly(rng, n, sigma_key, ternary)
        g = _sample_key_poly(rng, n, sigma_key, ternary)
        if not ntt.is_invertible(f):
            continue
        try:
            F, G = ntru_solve([int(c) for c in f], [int(c) for c in g], q)
        except ValueError as e:  # resultants not coprime enough
            last_err = e
            continue
        Fa = np.array(F, dtype=np.int64)
        Ga = np.array(G, dtype=np.int64)
        if max(_bitsize(F), _bitsize(G)) > 62:
            last_err = ValueError("F/G coefficients overflow int64; bad key")
            continue
        h = ntt.mul(g, ntt.inv(f))  # h = g * f^{-1} mod (q, x^n+1)
        # verify f G - g F == q exactly
        chk = np.array(
            _polymul_negacyclic([int(c) for c in f], G, n), dtype=object
        ) - np.array(_polymul_negacyclic([int(c) for c in g], F, n), dtype=object)
        if int(chk[0]) != q or any(int(c) != 0 for c in chk[1:]):
            last_err = ValueError("NTRUSolve verification failed")
            continue
        return {"f": f, "g": g, "F": Fa, "G": Ga, "h": h.astype(np.int64),
                "n": n, "q": q}
    raise RuntimeError(f"NTRU keygen failed after {max_tries} tries: {last_err}")


def _negacyclic_rot(h: np.ndarray) -> np.ndarray:
    """Columns j = coefficients of x^j * h mod (x^n + 1)."""
    h = np.asarray(h, dtype=np.int64)
    n = h.shape[0]
    M = np.zeros((n, n), dtype=np.int64)
    col = h.copy()
    for j in range(n):
        M[:, j] = col
        col = np.roll(col, 1)
        col[0] = -col[0]
    return M


def ntru_secret_basis(key: Dict[str, np.ndarray]) -> np.ndarray:
    """B = [[Rot(f), Rot(F)], [Rot(g), Rot(G)]], |det| = q^n."""
    n = int(key["n"])
    B = np.zeros((2 * n, 2 * n), dtype=np.int64)
    B[:n, :n] = _negacyclic_rot(key["f"])
    B[:n, n:] = _negacyclic_rot(key["F"])
    B[n:, :n] = _negacyclic_rot(key["g"])
    B[n:, n:] = _negacyclic_rot(key["G"])
    return B


def ntru_public_basis(h: np.ndarray, q: int) -> np.ndarray:
    """B = [[I, 0], [Rot(h), q I]] — the public CVP-sampling basis
    (reference ntru_clean.py:115-133 uses the transposed convention)."""
    h = np.asarray(h, dtype=np.int64)
    n = h.shape[0]
    B = np.zeros((2 * n, 2 * n), dtype=np.int64)
    B[:n, :n] = np.eye(n, dtype=np.int64)
    B[n:, :n] = _negacyclic_rot(h) % q
    B[n:, n:] = q * np.eye(n, dtype=np.int64)
    return B


def ntru_lattice(n: int, q: int = 12289, seed: int = 0, secret: bool = True,
                 ternary: bool = False, dtype=torch.float64, device=None,
                 cache_dir: Optional[str] = None,
                 key: Optional[Dict[str, np.ndarray]] = None) -> Lattice:
    """Build an NTRU lattice. `secret=True` uses the short secret basis (the
    one Klein sampling wants); otherwise the public basis. Keygen results are
    cached to `cache_dir` (npz) because NTRUSolve at n=512+ is an expensive
    one-time host computation; a cached key is read, never regenerated."""
    if key is None:
        cache_file = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            tern = "t" if ternary else "g"
            cache_file = os.path.join(cache_dir, f"ntru_{n}_{q}_{seed}_{tern}.npz")
            if os.path.exists(cache_file):
                with np.load(cache_file) as loaded:
                    key = {k: loaded[k] for k in loaded.files}
        if key is None:
            key = ntru_keygen(n, q, seed, ternary=ternary)
            if cache_file:
                np.savez_compressed(cache_file, **key)
    B = ntru_secret_basis(key) if secret else ntru_public_basis(key["h"], int(key["q"]))
    return lattice_from_basis(
        B, name=f"ntru(n={n},q={q},{'secret' if secret else 'public'})",
        meta={"kind": "ntru", "q": int(key["q"]), "ring_n": int(key["n"]),
              "secret": secret},
        dtype=dtype, device=device)


def ducas_prest_bound(n: int, q: int) -> float:
    """Design bound on the max GS norm of a good NTRU secret basis:
    ~1.17 sqrt(q) (reference checks max||b*|| vs sigma sqrt(2n),
    ntru.py:724-747)."""
    return 1.17 * math.sqrt(q)


def verify_ntru_basis(key: Dict[str, np.ndarray]) -> Dict[str, bool]:
    """Structural checks (reference verify_basis, ntru.py:749-801):
    f G - g F = q, h f = g mod q, |det B| = q^n (via GS norms)."""
    n, q = int(key["n"]), int(key["q"])
    f = [int(c) for c in key["f"]]
    g = [int(c) for c in key["g"]]
    F = [int(c) for c in key["F"]]
    G = [int(c) for c in key["G"]]
    chk = np.array(_polymul_negacyclic(f, G, n), dtype=object) - np.array(
        _polymul_negacyclic(g, F, n), dtype=object)
    ok_solve = int(chk[0]) == q and all(int(c) == 0 for c in chk[1:])
    ntt = NegacyclicNTT(n, q)
    ok_h = bool(np.all(ntt.mul(key["h"], key["f"]) % q
                       == np.asarray(key["g"]) % q))
    B = ntru_secret_basis(key).astype(np.float64)
    sign, logdet = np.linalg.slogdet(B)
    ok_det = abs(logdet - n * math.log(q)) < 1e-6 * n * math.log(q) + 1e-6
    return {"ntru_solve": ok_solve, "public_key": ok_h,
            "determinant": bool(ok_det)}
