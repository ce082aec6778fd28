"""Time kernels B1, B2 and B3 of one checkout of the port at the paths'
shapes, for comparing two trees on one card.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/ab_klein.py TREE [RING]

imports `lattice_gaussian_mcmc_tpu_torch` from the checkout at TREE (it
fails if the package comes from elsewhere), builds its kernels before any
timing, and prints one JSON line: the tree; B1 draws (each of B1_REPS
after a warm-up) and one 64-step B2 launch in ms by CUDA events at the
flagship's shapes (the NTRU key of ring degree RING, 512 by default, i.e.
dimension 1024, as `bench.py`'s BENCH_N; FALCON's sigma for it, 165.7 at
512 and 168.4 at 1024; window by tail budget 0.01; 524,288 chains) with
B2's accept count;
one 48-step B3 launch (lw ring only) at the hard-regime row's shapes
(sigma 0.45 max ||b*_i||, window by tail budget 0.01, 131,072 chains) with
its accept count (each count equal across trees whose kernels make the
same decisions, close otherwise); and ptxas's register lines. Run it for
parent, change, change, parent, one after another on the same card.
"""

from __future__ import annotations

import json
import os
import sys

CHAINS = 524288
B1_REPS = 5
STEPS = 64
HARD_CHAINS = 131072
HARD_STEPS = 48
HARD_SIGMA_OVER_MAX_GS = 0.45


def main(tree: str, ring: int = 512) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        falcon_parameters,
        ntru_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    if not klein_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {klein_cuda.__file__}, not {root}")
    _build.build_all()
    lat = ntru_lattice(ring, q=12289, seed=0,
                       cache_dir=os.path.join(root, "bench_cache"),
                       device="cuda")
    sigma = falcon_parameters(1024 if ring >= 1024 else 512)["sigma"]
    ops = klein_cuda.kernel_operands(
        klein_precompute(lat, sigma, tail_budget=0.01))

    def ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    y, lw = klein_cuda.klein_draw(ops, CHAINS, seed=7)   # warms
    b1 = [ms(lambda: klein_cuda.klein_draw(ops, CHAINS, seed=7))
          for _ in range(B1_REPS)]
    acc = torch.zeros_like(lw)
    b2 = ms(lambda: klein_cuda.imhk_fused(ops, y, lw, acc, STEPS, seed=7,
                                          step=1))
    del y, lw
    sigma_h = HARD_SIGMA_OVER_MAX_GS * float(lat.gs_norms.max())
    ops_h = klein_cuda.kernel_operands(
        klein_precompute(lat, sigma_h, tail_budget=0.01))
    x, lw_h = klein_cuda.klein_draw(ops_h, HARD_CHAINS, seed=100)
    acc_h = torch.zeros_like(lw_h)
    b3 = ms(lambda: klein_cuda.imhk_trajectory(
        ops_h, x, lw_h, acc_h, HARD_STEPS, 1, seed=100, step=1))
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "entry function" in ln or "registers" in ln]
             for name, info in _build.BUILD_INFO.items()
             if name in ("klein", "imhk_tc")}
    out = {"tree": tree, "dim": ops.n, "window": ops.window,
           "b1_ms": sorted(b1)[B1_REPS // 2], "b1_each_ms": b1,
           f"b2_{STEPS}_ms": b2,
           "accepted": float(acc.sum()), f"b3_{HARD_STEPS}_ms": b3,
           "b3_accepted": float(acc_h.sum()), "b3_window": ops_h.window,
           "ptxas": ptxas}
    if hasattr(klein_cuda, "imhk_tc_resources"):
        out["imhk_tc_resources"] = {
            w: klein_cuda.imhk_tc_resources(ops.n_pad, w)
            for w in (ops.window, ops_h.window)}
    return out


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    print(json.dumps(main(*sys.argv[1:2], *map(int, sys.argv[2:]))),
          flush=True)
