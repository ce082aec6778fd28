"""BKZ reduction quality on the port's `reduction/`: the GS profile and the
root-Hermite factor against the GSA model for BKZ-20, 30 and 40 on a
q-ary basis of dimension 128 (the port of the JAX package's
`scripts/bkz_quality.py`).

    python -m lattice_gaussian_mcmc_tpu_torch.tools.bkz_quality
        [--n 128] [--betas 20 30 40] [--out DIR]

delta_0 = (||b_1|| / det^(1/n))^(1/n) of each BKZ-beta basis (b_1 the
shortest column) should land near the model delta_0(beta)
(`lattices/qary.py` `_root_hermite`): the gate is |delta / model - 1| <=
0.02 for each beta, and delta_0 non-increasing in beta within 5e-4.
Host work (the native library of `reduction/build.py`); exits 2 without
it. The reduced basis follows the host's `-march=native` (hazard C12), so
the output carries the host's CPU model and ISA flags and each basis's
digest. Writes `<out>/bkz_quality.json` (default
`results/torch_validation/`); exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
Q = 3329
MAX_TOURS = 8
REL_GATE = 0.02
MONOTONE_SLACK = 5e-4
LLL_DELTA0 = 1.0219      # the classical LLL experimental constant


def root_hermite(basis_cols: np.ndarray) -> float:
    n = basis_cols.shape[0]
    # b_1 = the shortest basis vector (BKZ guarantees the quality of b_1;
    # the min over columns is layout-robust)
    b1 = float(np.min(np.linalg.norm(basis_cols.astype(float), axis=0)))
    logdet = float(np.linalg.slogdet(basis_cols.astype(float))[1])
    return (b1 / math.exp(logdet / n)) ** (1.0 / n)


def gs_profile(basis_cols: np.ndarray) -> np.ndarray:
    return np.abs(np.diag(np.linalg.qr(basis_cols.astype(float))[1]))


def run(n: int = 128, betas=(20, 30, 40), log=print) -> dict:
    """LLL, then BKZ-beta for each beta in turn on the q-ary basis of
    `default_rng(0)`'s (n/2, n/2) matrix mod 3329: the script's rows, each
    with the basis's digest, and the host's ISA flags."""
    from lattice_gaussian_mcmc_tpu_torch.lattices.qary import (
        _root_hermite,
        qary_basis,
    )
    from lattice_gaussian_mcmc_tpu_torch.reduction import (
        bkz_reduce,
        lll_reduce,
    )
    from lattice_gaussian_mcmc_tpu_torch.reduction.build import FLAGS
    from lattice_gaussian_mcmc_tpu_torch.tools.reduction_digest import (
        digest,
        host,
    )
    rng = np.random.default_rng(0)
    # (k, m) = (n/2, n/2) modular constraints: a q-ary basis of dimension n
    A = rng.integers(0, Q, size=(n // 2, n // 2))
    B = qary_basis(A, Q)
    t0 = time.perf_counter()
    L = lll_reduce(B)
    t_lll = time.perf_counter() - t0
    rows = [{"reduction": "lll", "seconds": t_lll,
             "delta0_measured": root_hermite(L), "delta0_model": LLL_DELTA0,
             "digest": digest(L), "gs_profile": list(map(float,
                                                         gs_profile(L)))}]
    R = L
    all_ok = True
    for beta in betas:
        t0 = time.perf_counter()
        R = bkz_reduce(R, beta=beta, max_tours=MAX_TOURS)
        dt = time.perf_counter() - t0
        d_meas = root_hermite(R)
        d_model = _root_hermite(beta)
        rel = d_meas / d_model - 1.0
        gs = gs_profile(R)
        # GSA slope: log||b*_i|| ~ const - i * log(delta0^2)
        slope = float(np.polyfit(np.arange(n), np.log(gs), 1)[0])
        passed = bool(abs(rel) <= REL_GATE)
        all_ok &= passed
        rows.append({"reduction": f"bkz-{beta}", "seconds": dt,
                     "delta0_measured": d_meas, "delta0_model": d_model,
                     "rel_deviation": rel, "gsa_slope_measured": slope,
                     "gsa_slope_model": -2.0 * math.log(d_model),
                     "digest": digest(R), "gs_profile": list(map(float, gs)),
                     "passed": passed})
        log(f"bkz-{beta}: delta0 {d_meas:.5f} vs model {d_model:.5f} "
            f"({100 * rel:+.2f}%) in {dt:.1f}s digest {digest(R)} "
            f"[{'PASS' if passed else 'FAIL'}]")
    # delta_0 must improve (or hold) with beta
    deltas = [r["delta0_measured"] for r in rows[1:]]
    monotone = all(deltas[i + 1] <= deltas[i] + MONOTONE_SLACK
                   for i in range(len(deltas) - 1))
    return {"n": n, "q": Q, "rows": rows, "host": host(),
            "reduction_flags": FLAGS, "monotone_in_beta": bool(monotone),
            "all_passed": bool(all_ok and monotone)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lattice_gaussian_mcmc_tpu_torch.tools.bkz_quality",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--betas", type=int, nargs="+", default=[20, 30, 40])
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "torch_validation"))
    args = ap.parse_args(argv)
    from lattice_gaussian_mcmc_tpu_torch.reduction import native_available
    if not native_available():
        print("bkz_quality: the native reduction library is unavailable",
              file=sys.stderr)
        return 2
    payload = run(args.n, tuple(args.betas))
    print(f"host: {json.dumps(payload['host'])} flags "
          f"{' '.join(payload['reduction_flags'])}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bkz_quality.json"), "w") as f:
        json.dump(payload, f, indent=2)
    print(f"all_passed: {payload['all_passed']}")
    return 0 if payload["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
