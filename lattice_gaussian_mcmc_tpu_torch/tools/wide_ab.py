"""Time B1, B2, B3 and B6 on their narrow and WIDE instantiations (fault
C11) on the same operands, and check that both draw the same.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/wide_ab.py [REPS]

The wrappers pick the instantiation with `klein_cuda.wide_y`; this tool
replaces it by a constant for each timing. Shapes are the smoke's: B1
(one draw, 524,288 chains) and B2 (one 64-step launch from that draw) at
the flagship's (NTRU-512 of seed 0, FALCON-512's sigma, window 16), B3 (one
48-step launch, lw ring only) at the hard-regime row's (sigma 0.45
max ||b*_i||, window 8, 131,072 chains), B6 (8 rounds, 65,536 chains) at
the suite klein row's at dimension 1024 (NTRU-512 of seed 42, sigma 1.3
max ||b*_i||, window 24). Each kernel is timed by CUDA events after a
warm-up launch of each instantiation, in the order narrow, WIDE, WIDE,
narrow, REPS times (2 by default). Prints one JSON line: each
instantiation's times in ms and their medians, WIDE's median over
narrow's, whether the two draws are equal (states, lw, accept counts),
the largest |y| and both instantiations' resources
(`klein_tc_resources`, `imhk_tc_resources`).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

FLAGSHIP_CHAINS, STEPS = 524288, 64
HARD_CHAINS, HARD_STEPS, HARD_SIGMA_OVER_MAX_GS = 131072, 48, 0.45
SUITE_CHAINS, SUITE_ROUNDS, SUITE_SIGMA_OVER_MAX_GS = 65536, 8, 1.3

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(reps: int = 2) -> dict:
    sys.path.insert(0, _ROOT)
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        falcon_parameters,
        ntru_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
        _build,
        klein_cuda,
        launch_record,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute

    _build.build_all()
    predict = klein_cuda.wide_y

    def ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    def ab(run):
        """run(wide) -> (ms, outputs); narrow, WIDE, WIDE, narrow, reps
        times, after a warm-up of each whose outputs are compared."""
        outs = {}
        for wide in (False, True):
            klein_cuda.wide_y = lambda ops, w=wide: w
            outs[wide] = run(wide)[1]
        same = all(torch.equal(a, b) for a, b in zip(outs[False],
                                                     outs[True]))
        del outs
        times = {False: [], True: []}
        for _ in range(reps):
            for wide in (False, True, True, False):
                klein_cuda.wide_y = lambda ops, w=wide: w
                t, out = run(wide)
                del out
                times[wide].append(t)
        klein_cuda.wide_y = predict
        med = {w: statistics.median(v) for w, v in times.items()}
        return {"narrow_ms": times[False], "wide_ms": times[True],
                "narrow_median_ms": med[False], "wide_median_ms": med[True],
                "wide_over_narrow": med[True] / med[False], "same": same}

    def timed(fn):
        box = []
        t = ms(lambda: box.append(fn()))
        return t, box[0]

    cache = os.path.join(_ROOT, "bench_cache")
    lat = ntru_lattice(512, q=12289, seed=0, cache_dir=cache, device="cuda")
    ops = klein_cuda.kernel_operands(klein_precompute(
        lat, falcon_parameters(512)["sigma"], tail_budget=0.01))
    out = {"predicted_wide": {"flagship": predict(ops)}}
    out["b1"] = ab(lambda w: timed(
        lambda: klein_cuda.klein_draw(ops, FLAGSHIP_CHAINS, seed=7)))
    y, lw = klein_cuda.klein_draw(ops, FLAGSHIP_CHAINS, seed=7)
    out["b1"]["max_abs_y"] = launch_record.read()["klein_draw"]["max_abs_y"]

    def b2(wide):
        x, l, a = y.clone(), lw.clone(), torch.zeros_like(lw)
        t = ms(lambda: klein_cuda.imhk_fused(ops, x, l, a, STEPS, seed=7,
                                             step=1))
        return t, (x, l, a)

    out["b2"] = ab(b2)
    out["b2"]["max_abs_y"] = launch_record.read()["imhk_fused"]["max_abs_y"]
    del y, lw

    sigma_h = HARD_SIGMA_OVER_MAX_GS * float(lat.gs_norms.max())
    ops_h = klein_cuda.kernel_operands(
        klein_precompute(lat, sigma_h, tail_budget=0.01))
    out["predicted_wide"]["hard_regime"] = predict(ops_h)
    xh, lwh = klein_cuda.klein_draw(ops_h, HARD_CHAINS, seed=100)

    def b3(wide):
        x, l, a = xh.clone(), lwh.clone(), torch.zeros_like(lwh)
        box = []
        t = ms(lambda: box.append(klein_cuda.imhk_trajectory(
            ops_h, x, l, a, HARD_STEPS, 1, seed=100, step=1)))
        return t, (x, l, a, box[0][4])

    out["b3"] = ab(b3)
    out["b3"]["max_abs_y"] = \
        launch_record.read()["imhk_trajectory"]["max_abs_y"]
    del xh, lwh

    lat42 = ntru_lattice(512, q=12289, seed=42, cache_dir=cache,
                         device="cuda")
    ops6 = klein_cuda.kernel_operands(klein_precompute(
        lat42, SUITE_SIGMA_OVER_MAX_GS * float(lat42.gs_norms.max()),
        tail_budget=0.01))
    out["predicted_wide"]["suite_1024"] = predict(ops6)
    out["b6"] = ab(lambda w: timed(lambda: klein_cuda.klein_ring(
        ops6, SUITE_CHAINS, SUITE_ROUNDS, seed=5)))
    out["b6"]["max_abs_y"] = launch_record.read()["klein_ring"]["max_abs_y"]

    out["windows"] = {"flagship": ops.window, "hard_regime": ops_h.window,
                      "suite_1024": ops6.window}
    out["resources"] = {
        f"{mode}_w{w}": klein_cuda.klein_tc_resources(o.n_pad, w, mode)
        for mode, o, w in (("b1", ops, ops.window),
                           ("b1_wide", ops, ops.window),
                           ("b6", ops6, ops6.window),
                           ("b6_wide", ops6, ops6.window))}
    for o in (ops, ops_h):
        for wide in (False, True):
            out["resources"][f"b2{'_wide' if wide else ''}_w{o.window}"] = (
                klein_cuda.imhk_tc_resources(o.n_pad, o.window, wide))
    return out


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:2]))))
