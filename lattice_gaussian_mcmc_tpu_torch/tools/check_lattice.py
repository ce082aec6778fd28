"""Lattice construction check (the port of the JAX package's
`scripts/check_lattice.py`).

    python -m lattice_gaussian_mcmc_tpu_torch.tools.check_lattice
        {zn,qary,ntru} [n] [sigma] [--device cpu]

Builds the named lattice (n is the dimension of zn and qary and the ring
degree of ntru, whose key is read from `bench_cache/`), prints its
geometry (det, GS profile, smoothing parameter, Gaussian heuristic, Klein
window at sigma, by default 1.3 max||b*_i||) and checks its invariants:
  - |det B| == prod ||b*_i||  (GSO consistency),
  - NTRU: det == q^n,
  - q-ary: q Z^n inside the lattice (q e_i has integer coefficients),
  - the Klein precomputation's window below MAX_WINDOW (not clamped).
The lattice's factors live on the card unless `--device cpu` is given.
Exits 0 on PASS, 1 on FAIL, 2 with no card and no `--device cpu`.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    device_from_argv,
    resolve_device,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build(kind: str, n: int, device):
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        ntru_lattice,
        qary_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.lattices.identity import (
        identity_lattice,
    )
    if kind == "zn":
        return identity_lattice(n, device=device)
    if kind == "qary":
        return qary_lattice(n, n // 2, q=3329, seed=0, device=device)
    if kind == "ntru":
        return ntru_lattice(n, q=12289, seed=0, device=device,
                            cache_dir=os.path.join(_ROOT, "bench_cache"))
    raise SystemExit(f"unknown lattice kind {kind!r}")


def main(argv=None) -> int:
    from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
        gaussian_heuristic,
        smoothing_parameter,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
        MAX_WINDOW,
        klein_precompute,
    )
    args, device = device_from_argv(sys.argv[1:] if argv is None else argv)
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"check_lattice: {e}", file=sys.stderr)
        return 2
    kind = args[0] if len(args) > 0 else "qary"
    n = int(args[1]) if len(args) > 1 else 64
    ok = True
    lat = build(kind, n, device)

    B = lat.basis.cpu().numpy().astype(np.float64)
    gs = lat.gs_norms.cpu().numpy().astype(np.float64)
    _, logdet = np.linalg.slogdet(B)
    log_gs = np.log(gs).sum()
    eta = float(smoothing_parameter(lat))
    gh = float(gaussian_heuristic(lat))
    print(f"{lat.name}: n={lat.n}  log|det|={logdet:.4f}  "
          f"sum log||b*||={log_gs:.4f}")
    print(f"GS profile: max={gs.max():.4g} min={gs.min():.4g} "
          f"ratio={gs.max() / gs.min():.4g}")
    print(f"eta_0.01={eta:.4g}  gaussian_heuristic={gh:.4g}")

    if abs(logdet - log_gs) > 1e-6 * max(abs(logdet), 1.0):
        print("FAIL: det != prod ||b*_i||")
        ok = False

    if kind == "ntru":
        q = int(lat.meta.get("q", 12289))
        expect = lat.n // 2 * math.log(q)
        if abs(logdet - expect) > 1e-6 * expect:
            print(f"FAIL: NTRU det != q^n (log {logdet:.4f} vs {expect:.4f})")
            ok = False
        else:
            print(f"NTRU det == q^n OK (q={q})")
    if kind == "qary":
        q = int(lat.meta.get("q", 3329))
        # q*e_i must be lattice points: coeffs = B^-1 (q e_i) integral
        coeffs = np.linalg.solve(B, q * np.eye(lat.n))
        if not np.allclose(coeffs, np.round(coeffs), atol=1e-6):
            print("FAIL: q*Z^n not contained in the q-ary lattice")
            ok = False
        else:
            print(f"q*Z^n subset OK (q={q})")

    sigma = float(args[2]) if len(args) > 2 else 1.3 * gs.max()
    klein_floor = gs.max() / math.sqrt(2.0 * math.log(max(lat.n, 2)))
    pre = klein_precompute(lat, sigma)
    clamped = pre.window >= MAX_WINDOW
    print(f"sigma={sigma:.4g} (floor {klein_floor:.4g}): window={pre.window}"
          f"{' CLAMPED — law will be biased' if clamped else ''}")
    if clamped:
        ok = False

    print(f"\ncheck: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
