"""Time kernels B1-B8 of one checkout of the port at the paths' shapes,
for comparing two trees on one card.

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
same decisions, close otherwise); at ring degree 512 also one 32-step B4
launch at the SMK row's shapes (proposal 0.45 sigma of the hard-regime
row's, window 8, 131,072 chains from a Klein draw) with its accept count,
and B5 at the Peikert row's shapes (sigma 1.05 r s1(B), window 24, 8
rounds) at 65,536 and at 4,096 chains, with its plain version's time at
4,096, B5 at NTRU-1024 (dimension 2048, the Peikert row at BENCH_N =
1024; 8 rounds at 65,536 chains, 2 at 4,096 with its plain version's
time, or the error of a tree that raises there), B6 at the suite klein
row's shapes (NTRU-512 of seed 42, sigma 1.3 max ||b*_i||, window 24,
65,536 chains x 8 rounds), B7 at the decode phase's (65,536 targets
B x* + w, noise 0.45 min ||b*_i||; median of B7_REPS) and the whole
`Lattice.nearest_plane` on those targets (median of B7_REPS, float64
centre products included), B8 at the suite
direct row's (65,536 x 1024 draws, sigma 5, window 48; the median of
B8_REPS timings of B8_BATCH launches each, per launch) and there the same
against a copy of B8 that pads its CDF at run time (`_b8_pads`); ptxas's
register lines; and a digest of each library's SASS (`cuobjdump -sass`, the
anonymous namespace's per-build name folded out), equal across two trees
whose kernels compile to the same code. Run it for parent, change,
change, parent, one after another on the same card.
"""

from __future__ import annotations

import json
import os
import sys

CHAINS = 524288
B1_REPS = 5
SMK_STEPS = 32
PEIKERT_CHAINS, PEIKERT_CHECK_CHAINS, PEIKERT_ROUNDS = 65536, 4096, 8
PEIKERT_CHECK_ROUNDS = 2
SUITE_CHAINS, SUITE_ROUNDS = 65536, 8
DECODE_TARGETS = 65536
B7_REPS = 5
LIBRARIES = ("imhk_tc", "klein", "klein_tc", "peikert_tc", "smk_tc", "zn")
ZN_DRAWS, ZN_SIGMA = 65536 * 1024, 5.0
B8_REPS, B8_BATCH = 5, 20
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
    # this tool's neighbour, on TREE's `_build`: a tree without it is timed
    # all the same
    import sass
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
    if ring == 512:
        out_45 = _b4_b5(lat, sigma_h, ms)
        out_45.update(_b5_wide(root, ms), **_b6_b7_b8(root, lat, ms))
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "entry function" in ln or "registers" in ln]
             for name, info in _build.BUILD_INFO.items()}
    out = {"tree": tree, "dim": ops.n, "window": ops.window,
           "b1_ms": sorted(b1)[B1_REPS // 2], "b1_each_ms": b1,
           f"b2_{STEPS}_ms": b2,
           "accepted": float(acc.sum()), f"b3_{HARD_STEPS}_ms": b3,
           "b3_accepted": float(acc_h.sum()), "b3_window": ops_h.window,
           "ptxas": ptxas}
    out["sass_digest"] = sass.digests(LIBRARIES)
    if hasattr(klein_cuda, "imhk_tc_resources"):
        out["imhk_tc_resources"] = {
            w: klein_cuda.imhk_tc_resources(ops.n_pad, w)
            for w in (ops.window, ops_h.window)}
    if ring == 512:
        out.update(out_45)
    return out


def _b4_b5(lat, sigma_h, ms) -> dict:
    """B4 and B5 at the SMK and Peikert rows' shapes on the lattice of ring
    degree 512, each after a warm-up launch."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
        klein_cuda,
        peikert_cuda,
        smk_cuda,
    )
    from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
        smoothing_parameter_zn,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        PeikertSampler,
        SMKSampler,
    )
    ss = SMKSampler(lat, sigma_h, proposal_sigma=0.45 * sigma_h,
                    tail_budget=0.01)
    x, _ = klein_cuda.klein_draw(ss.klein_operands, HARD_CHAINS, seed=31)
    acc = torch.zeros(HARD_CHAINS, device="cuda")
    smk_cuda.smk_steps(ss.operands, x.clone(), acc.clone(), 1, seed=400,
                       step=1)
    b4 = ms(lambda: smk_cuda.smk_steps(ss.operands, x, acc, SMK_STEPS,
                                       seed=400, step=1))
    del x
    s1 = float(np.linalg.norm(lat.basis.cpu().double().numpy(), 2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    ops_p = PeikertSampler(lat, 1.05 * r * s1).operands
    b5 = {}
    for B in (PEIKERT_CHAINS, PEIKERT_CHECK_CHAINS):
        peikert_cuda.peikert_rounds(ops_p, B, PEIKERT_ROUNDS, seed=502)
        b5[B] = ms(lambda: peikert_cuda.peikert_rounds(
            ops_p, B, PEIKERT_ROUNDS, seed=502))
    plain = ms(lambda: peikert_cuda.peikert_rounds_plain(
        ops_p, PEIKERT_CHECK_CHAINS, PEIKERT_ROUNDS, seed=502))
    return {f"b4_{SMK_STEPS}_ms": b4, "b4_accepted": float(acc.sum()),
            "b4_window": ss.operands.window,
            f"b5_{PEIKERT_CHAINS}_ms": b5[PEIKERT_CHAINS],
            f"b5_{PEIKERT_CHECK_CHAINS}_ms": b5[PEIKERT_CHECK_CHAINS],
            f"b5_{PEIKERT_CHECK_CHAINS}_plain_ms": plain,
            "b5_rounds": PEIKERT_ROUNDS, "b5_window": ops_p.window}


def _b5_wide(root, ms) -> dict:
    """B5 at NTRU-1024 (dimension 2048), sigma 1.05 r s1(B): 8 rounds at
    65,536 chains and 2 at 4,096 with the plain version's time, each after
    a warm-up launch; a tree whose wrapper raises there reports why."""
    import numpy as np
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
    from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
        smoothing_parameter_zn,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import PeikertSampler
    lat = ntru_lattice(1024, q=12289, seed=0,
                       cache_dir=os.path.join(root, "bench_cache"),
                       device="cuda")
    s1 = float(np.linalg.norm(lat.basis.cpu().double().numpy(), 2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    ops = PeikertSampler(lat, 1.05 * r * s1).operands
    out = {"b5_2048_window": ops.window}
    try:
        for B, R in ((PEIKERT_CHAINS, PEIKERT_ROUNDS),
                     (PEIKERT_CHECK_CHAINS, PEIKERT_CHECK_ROUNDS)):
            peikert_cuda.peikert_rounds(ops, B, R, seed=502)
            out[f"b5_2048_{B}x{R}_ms"] = ms(
                lambda: peikert_cuda.peikert_rounds(ops, B, R, seed=502))
    except ValueError as e:
        out["b5_2048_error"] = str(e)
    out[f"b5_2048_{PEIKERT_CHECK_CHAINS}x{PEIKERT_CHECK_ROUNDS}_plain_ms"] = (
        ms(lambda: peikert_cuda.peikert_rounds_plain(
            ops, PEIKERT_CHECK_CHAINS, PEIKERT_CHECK_ROUNDS, seed=502)))
    return out


def _b6_b7_b8(root, lat, ms) -> dict:
    """B6 at the suite klein row's shapes, B7 at the decode phase's and B8
    at the suite direct row's, each after a warm-up launch."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, zn_cuda
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
        suggest_peikert_window,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    lat42 = ntru_lattice(512, q=12289, seed=42,
                         cache_dir=os.path.join(root, "bench_cache"),
                         device="cuda")
    ops = klein_cuda.kernel_operands(klein_precompute(
        lat42, 1.3 * float(lat42.gs_norms.max()), tail_budget=0.01))
    klein_cuda.klein_ring(ops, SUITE_CHAINS, SUITE_ROUNDS, seed=5)
    b6 = ms(lambda: klein_cuda.klein_ring(ops, SUITE_CHAINS, SUITE_ROUNDS,
                                          seed=5))
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = torch.randint(-2, 3, (DECODE_TARGETS, lat.n), device="cuda",
                       generator=gen).double()
    w = torch.randn(DECODE_TARGETS, lat.n, device="cuda", generator=gen,
                    dtype=torch.float64)
    t = xs @ lat.basis.T + 0.45 * float(lat.gs_norms.min()) * w
    ops7 = klein_cuda.babai_operands(lat.Q, lat.R)
    ct, _ = klein_cuda.babai_centres(ops7, t)
    klein_cuda.babai_decode(ops7, ct)
    b7 = [ms(lambda: klein_cuda.babai_decode(ops7, ct))
          for _ in range(B7_REPS)]
    del ct
    lat.nearest_plane(t)
    decode = [ms(lambda: lat.nearest_plane(t)) for _ in range(B7_REPS)]
    del t, w, xs
    W = suggest_peikert_window(ZN_SIGMA, lat.n)

    def b8_batch():
        for _ in range(B8_BATCH):
            zn_cuda.sample_zn_draws(ZN_DRAWS, ZN_SIGMA, 0.0, W, seed=5,
                                    device="cuda")

    b8_batch()
    b8 = [ms(b8_batch) / B8_BATCH for _ in range(B8_REPS)]
    pads = _b8_pads(W, ms)
    return {**pads, f"b6_{SUITE_CHAINS}x{SUITE_ROUNDS}_ms": b6,
            "b6_window": ops.window,
            f"b7_{DECODE_TARGETS}_ms": sorted(b7)[B7_REPS // 2],
            "b7_each_ms": b7,
            f"nearest_plane_{DECODE_TARGETS}_ms": sorted(decode)[B7_REPS // 2],
            "nearest_plane_each_ms": decode,
            f"b8_{ZN_DRAWS}_ms": sorted(b8)[B8_REPS // 2],
            "b8_each_ms": b8, "b8_window": W}


def _b8_pads(window, ms) -> dict:
    """B8 at the suite direct row's shapes, as built (a window up to 64
    takes the instantiation that pads its CDF to 64 at compile time)
    against a copy whose every window takes the padding chosen at run
    time, in turns compiled, run time, run time, compiled (each the median
    of B8_REPS timings of B8_BATCH launches, per launch), with whether the
    two wrote the same draws. A tree without the compiled instantiation
    reports none."""
    import ctypes
    import shutil
    import tempfile
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, zn_cuda
    from lattice_gaussian_mcmc_tpu_torch.utils.prng import seed_key
    dest = tempfile.mkdtemp(prefix="zn_pad_")
    try:
        _build.edited_sources(dest, "zn.cu", [(
            "if (window <= ZN_COMPILED_P)", "if (false)")])
        libs = {"compiled": _build.load("zn"),
                "run_time": _build.load("zn", dest)}
    except ValueError:
        return {}
    finally:
        shutil.rmtree(dest)
    c, isg = zn_cuda._params(ZN_SIGMA, 0.0)
    k0, k1 = seed_key(5)
    outs = {k: torch.empty(ZN_DRAWS, device="cuda") for k in libs}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def batch(k):
        for _ in range(B8_BATCH):
            rc = libs[k].zn_draw_launch(c, isg, window, None,
                                        _build.ptr(outs[k]), ZN_DRAWS, k0,
                                        k1, stream)
            _build.raise_on("zn", rc, f"B8 ({k})")

    out = {}
    for k in ("compiled", "run_time", "run_time", "compiled"):
        batch(k)
        t = sorted(ms(lambda: batch(k)) / B8_BATCH for _ in range(B8_REPS))
        out.setdefault(f"b8_pad_{k}_ms", []).append(t[B8_REPS // 2])
    out["b8_pad_same_draws"] = torch.equal(outs["compiled"],
                                           outs["run_time"])
    return out


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    print(json.dumps(main(*sys.argv[1:2], *map(int, sys.argv[2:]))),
          flush=True)
