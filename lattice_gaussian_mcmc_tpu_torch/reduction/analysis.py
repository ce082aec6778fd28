"""Reduction quality analytics + sampling-oriented reduction search (a copy
of the JAX package's `reduction/analysis.py`; host numpy).

Parity: reference `src/lattices/reduction.py` — Hermite factor (:322-346),
orthogonality defect (:348-371), `basis_quality_profile` (:373-405),
`sampling_reduce` search over LLL delta / BKZ beta minimizing max||b*_i||
(:409-489), reduction cost model (:581-625), basis comparison report
(:627-696), per-lattice-type strategy heuristics (:701-764).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from lattice_gaussian_mcmc_tpu_torch.reduction.lll import (
    bkz_reduce,
    lll_reduce,
    native_available,
)


def _gs_norms(basis_cols: np.ndarray) -> np.ndarray:
    R = np.linalg.qr(np.asarray(basis_cols, dtype=np.float64))[1]
    return np.abs(np.diag(R))


def hermite_factor(basis_cols: np.ndarray) -> float:
    """gamma = (||b_1|| / det^{1/n})^{1/n} (reference reduction.py:322-346)."""
    B = np.asarray(basis_cols, dtype=np.float64)
    n = B.shape[0]
    b1 = np.linalg.norm(B[:, 0])
    logdet = np.linalg.slogdet(B)[1]
    return float((b1 / math.exp(logdet / n)) ** (1.0 / n))


def orthogonality_defect(basis_cols: np.ndarray) -> float:
    """prod ||b_i|| / det (>= 1; 1 iff orthogonal)
    (reference reduction.py:348-371). Returned in log form for stability as
    exp(log defect)."""
    B = np.asarray(basis_cols, dtype=np.float64)
    log_prod = float(np.sum(np.log(np.linalg.norm(B, axis=0))))
    logdet = float(np.linalg.slogdet(B)[1])
    return math.exp(log_prod - logdet)


def basis_quality_profile(basis_cols: np.ndarray) -> Dict[str, object]:
    """GS norms, ratios, log-potential, condition number
    (reference reduction.py:373-405)."""
    gs = _gs_norms(basis_cols)
    n = len(gs)
    log_potential = float(sum((n - i) * math.log(g) for i, g in enumerate(gs)))
    return {
        "gs_norms": gs,
        "min_gs_norm": float(gs.min()),
        "max_gs_norm": float(gs.max()),
        "gs_ratio": float(gs.max() / gs.min()),
        "log_potential": log_potential,
        "hermite_factor": hermite_factor(basis_cols),
        "orthogonality_defect": orthogonality_defect(basis_cols),
        "condition_number": float(np.linalg.cond(
            np.asarray(basis_cols, dtype=np.float64))),
    }


def sampling_reduce(basis_cols: np.ndarray, target_sigma: float,
                    deltas=(0.75, 0.85, 0.95, 0.99),
                    betas=(20, 30, 40)) -> Dict[str, object]:
    """Search reduction strategies minimizing max||b*_i|| (the quantity that
    gates Klein's sigma requirement) until target_sigma is feasible
    (reference reduction.py:409-489). Returns the best basis + report."""
    n = np.asarray(basis_cols).shape[0]
    need = target_sigma * math.sqrt(2 * math.log(n + 1))
    best = {"basis": np.asarray(basis_cols), "max_gs": _gs_norms(basis_cols).max(),
            "strategy": "none"}
    for d in deltas:
        t0 = time.perf_counter()
        red = lll_reduce(basis_cols, delta=d)
        mg = _gs_norms(red).max()
        if mg < best["max_gs"]:
            best = {"basis": red, "max_gs": mg, "strategy": f"LLL(delta={d})",
                    "time_s": time.perf_counter() - t0}
        if best["max_gs"] <= need:
            best["sigma_feasible"] = True
            return best
    if native_available():
        for b in betas:
            t0 = time.perf_counter()
            red = bkz_reduce(best["basis"], beta=b)
            mg = _gs_norms(red).max()
            if mg < best["max_gs"]:
                best = {"basis": red, "max_gs": mg, "strategy": f"BKZ(beta={b})",
                        "time_s": time.perf_counter() - t0}
            if best["max_gs"] <= need:
                break
    best["sigma_feasible"] = bool(best["max_gs"] <= need)
    return best


def compare_bases(original: np.ndarray, reduced: np.ndarray) -> Dict[str, object]:
    """Before/after quality report (reference reduction.py:627-696)."""
    p0 = basis_quality_profile(original)
    p1 = basis_quality_profile(reduced)
    return {
        "original": {k: v for k, v in p0.items() if k != "gs_norms"},
        "reduced": {k: v for k, v in p1.items() if k != "gs_norms"},
        "max_gs_improvement": p0["max_gs_norm"] / p1["max_gs_norm"],
        "defect_improvement": (p0["orthogonality_defect"] /
                               p1["orthogonality_defect"]),
    }


def reduction_cost_model(n: int, beta: Optional[int] = None) -> Dict[str, float]:
    """Rough cost estimates: LLL ~ O(n^4 log B); BKZ enumeration
    2^{0.187 beta log beta} (reference reduction.py:581-625)."""
    out = {"lll_ops": float(n**4)}
    if beta:
        out["bkz_enum_ops_log2"] = 0.187 * beta * math.log2(max(beta, 2))
        out["bkz_tour_calls"] = float(n)
    return out


def recommend_strategy(lattice_kind: str, n: int,
                       target_sigma: Optional[float] = None) -> Dict[str, object]:
    """Per-lattice-type reduction heuristics (reference reduction.py:701-764).
    """
    if lattice_kind == "identity":
        return {"strategy": "none", "reason": "Z^n is already orthogonal"}
    if lattice_kind == "ntru":
        return {"strategy": "none", "reason":
                "secret NTRU basis is already short (Ducas-Prest); reduce "
                "only the public basis", "fallback": "BKZ(beta=20)"}
    if lattice_kind in ("qary", "rlwe", "module"):
        beta = 20 if n <= 128 else (30 if n <= 512 else 40)
        return {"strategy": f"LLL(0.99) then BKZ(beta={beta})",
                "delta": 0.99, "beta": beta}
    return {"strategy": "LLL(0.99)", "delta": 0.99}


def lll_with_removals(basis_cols: np.ndarray, keep: int,
                      delta: float = 0.99) -> np.ndarray:
    """LLL-reduce, then keep only the `keep` shortest GS-profile prefix
    vectors (reference reduction.py:188-234 "LLL-with-removals": drop
    trailing vectors whose GS norm exceeds a bound — used to trim q-ary
    bases before enumeration). Returns an (n, keep) column matrix."""
    red = lll_reduce(basis_cols, delta=delta)
    return np.asarray(red)[:, :keep]


def local_gs_swap_improve(basis_cols: np.ndarray,
                          max_passes: int = 4) -> np.ndarray:
    """Greedy local improvement: swap adjacent basis vectors whenever doing
    so reduces max||b*_i|| (reference reduction.py:491-535). Cheap polish
    after LLL for sampling-oriented quality."""
    B = np.array(basis_cols, dtype=np.float64)
    n = B.shape[1]
    for _ in range(max_passes):
        improved = False
        base = _gs_norms(B).max()
        for i in range(n - 1):
            Bs = B.copy()
            Bs[:, [i, i + 1]] = Bs[:, [i + 1, i]]
            if _gs_norms(Bs).max() < base - 1e-12:
                B = Bs
                base = _gs_norms(B).max()
                improved = True
        if not improved:
            break
    return B
