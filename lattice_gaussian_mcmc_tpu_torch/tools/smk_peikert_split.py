"""Split the time of B4 (fused SMK) and B5 (Peikert) between their parts,
at the shapes of `bench.py`'s SMK and Peikert rows.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/smk_peikert_split.py [TREE]

For the checkout at TREE (the one holding this file by default), builds
copies of its B4 and B5 sources (`_build.edited_sources`) with one part of
the kernel cut out each, and launches every copy through that tree's own
wrappers (`smk_cuda.smk_steps`, `peikert_cuda.peikert_rounds`), so the
same tool splits two generations of a kernel whose launch signatures
differ. The cuts are chosen by the source files the tree has (`CUTS`).

B4: NTRU-512 (dimension 1024), sigma 0.45 max ||b*_i||, proposal 0.45
sigma, window by tail budget 0.01 (8), 131,072 chains from a Klein draw,
32 steps. B5: sigma 1.05 r s1(B), window 24, 65,536 chains x 8 rounds.
Each copy is launched once to warm, then in turns full, cuts ...,
cuts reversed, full, timed by CUDA events. Prints one JSON line with the
times, the card and ptxas's register lines. The cut copies compute the
wrong law on purpose; they only time the parts. Needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMK_CHAINS, SMK_STEPS = 131_072, 32
PEIKERT_CHAINS, PEIKERT_ROUNDS = 65_536, 8

# kernel -> source file the tree has -> cut -> [(file edited, [(old, new)])]
CUTS = {
    "B4": {
        "smk.cu": {
            "no_coupling": [("klein_common.cuh", [(
                "    cross_block(op.UT, n_pad, lo, ybuf, B, chain, col);",
                "    if (SMK) { for (int r = 0; r < RB; ++r) col[r * THREADS]"
                " = 0.0f; } else cross_block(op.UT, n_pad, lo, ybuf, B, "
                "chain, col);")])],
            "no_draws": [("klein_common.cuh", [(
                "const float y = draw_row<W>(c, __ldg(op.isg + i), u, "
                "op.window, logz);",
                "const float y = SMK ? (logz = 0.0f, rintf(c)) : "
                "draw_row<W>(c, __ldg(op.isg + i), u, op.window, logz);")])],
            "no_reverse": [("smk.cu", [(
                "    for (int i = 0; i < n_pad; ++i) {\n"
                "      const size_t at = (size_t)i * (size_t)B + "
                "(size_t)chain;\n      const float cti",
                "    for (int i = 0; i < n_pad && s < 0; ++i) {\n"
                "      const size_t at = (size_t)i * (size_t)B + "
                "(size_t)chain;\n      const float cti")])],
            "no_accept_copy": [("smk.cu", [(
                "        x[at] = prop[at];\n        ct[at] = ctn[at];\n",
                "")])],
        },
        "smk_tc.cu": {
            "no_coupling": [("smk_tc.cu", [(
                "couple<PASSES>(op, ysm, cacc, lo, warp, lane);",
                "zero(cacc); if (lo < 0) couple<PASSES>(op, ysm, cacc, lo, "
                "warp, lane);")])],
            "no_draws": [("smk_tc.cu", [(
                "const float y = draw_pair<W>(c, isg, upair[e], op.window, "
                "h,\n                                         lane, logz);",
                "const float y = rintf(c); logz = 0.0f;")])],
            "no_reverse": [("smk_tc.cu", [(
                "for (int k = 0; k < SB / 2; ++k) {",
                "for (int k = 0; k < SB / 2 && lo < 0; ++k) {")])],
            "no_accept_copy": [("smk_tc.cu", [(
                "if (ch < B && accepted[cc] != 0)",
                "if (ch < B && accepted[cc] != 0 && s < 0)")])],
        },
    },
    "B5": {
        "peikert_tc.cu": {
            "no_product": [("peikert_tc.cu", [(
                "for (int kt = 0; kt < kend; kt += 2) {",
                "for (int kt = 0; kt < kend && rnd < 0; kt += 2) {")])],
            "no_draws": [("peikert_tc.cu", [(
                "ring[at] = draw_row<W>(c, isg, u, window, logz);",
                "ring[at] = rintf(c); (void)u; (void)logz;")])],
            "no_box_muller": [("peikert_tc.cu", [
                ("const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));",
                 "const float rad = u1;"),
                ("__fmul_rn(rad, cosf(ang));", "__fmul_rn(rad, ang);"),
                ("__fmul_rn(rad, sinf(ang));", "__fadd_rn(rad, ang);")])],
            "no_normals": [("peikert_tc.cu", [(
                "for (int p = tid / NCP; p < n_pad / 2; p += PTPB / NCP) {",
                "for (int p = tid / NCP; p < n_pad / 2 && rnd < 0; "
                "p += PTPB / NCP) {")])],
        },
        "peikert.cu": {
            "no_product": [("peikert.cu", [(
                "      for (int j = 0; j < hi; ++j) {",
                "      for (int j = 0; j < hi && rnd < 0; ++j) {")])],
            "no_draws": [("peikert.cu", [(
                "draw_row<W>(c, isg, u, window, logz);",
                "rintf(c); (void)u; (void)logz;")])],
            "no_box_muller": [("peikert.cu", [
                ("const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));",
                 "const float rad = u1;"),
                ("__fmul_rn(rad, cosf(ang));", "__fmul_rn(rad, ang);"),
                ("__fmul_rn(rad, sinf(ang));", "__fadd_rn(rad, ang);")])],
            "no_normals": [("peikert.cu", [(
                "for (int p = 0; p < n_pad / 2; ++p) {",
                "for (int p = 0; p < n_pad / 2 && rnd < 0; ++p) {")])],
        },
    },
}


def _cut_set(kernel, csrc):
    for src, cuts in CUTS[kernel].items():
        if os.path.exists(os.path.join(csrc, src)):
            return src, cuts
    raise RuntimeError(f"no known {kernel} source in {csrc}")


def main(tree: str) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
        _build,
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
    if not smk_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {smk_cuda.__file__}, not {root}")
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(root, "bench_cache"),
                       device="cuda")
    sigma = 0.45 * float(lat.gs_norms.max())
    ss = SMKSampler(lat, sigma, proposal_sigma=0.45 * sigma,
                    tail_budget=0.01)
    y0, _ = klein_cuda.klein_draw(ss.klein_operands, SMK_CHAINS, seed=31)
    s1 = float(np.linalg.norm(lat.basis.cpu().double().numpy(), 2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    ops_p = PeikertSampler(lat, 1.05 * r * s1).operands

    def ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    def run_b4():
        x, acc = y0.clone(), torch.zeros(SMK_CHAINS, device="cuda")
        # a cut copy may leave the range where its bf16 coupling is exact:
        # give it a guard that is never read (the launch record's, or B4's
        # own in trees before it; trees before the guard have none)
        try:
            from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
                launch_record,
            )
            kw = {"guard": launch_record.ExactGuard("cuda")}
        except ImportError:
            kw = ({"guard": smk_cuda.exact_guard("cuda")}
                  if hasattr(smk_cuda, "exact_guard") else {})
        t = ms(lambda: smk_cuda.smk_steps(ss.operands, x, acc, SMK_STEPS,
                                          seed=400, step=1, **kw))
        return t, float(acc.sum())

    def run_b5():
        return ms(lambda: peikert_cuda.peikert_rounds(
            ops_p, PEIKERT_CHAINS, PEIKERT_ROUNDS, seed=502)), math.nan

    csrc = os.path.join(root, "lattice_gaussian_mcmc_tpu_torch", "csrc")
    out = {"tree": tree, "smk": {"chains": SMK_CHAINS, "steps": SMK_STEPS,
                                 "window": ss.operands.window},
           "peikert": {"chains": PEIKERT_CHAINS, "rounds": PEIKERT_ROUNDS,
                       "window": ops_p.window}}
    with tempfile.TemporaryDirectory() as tmp:
        for kernel, mod, run, key in (("B4", smk_cuda, run_b4, "smk"),
                                      ("B5", peikert_cuda, run_b5,
                                       "peikert")):
            src, cuts = _cut_set(kernel, csrc)
            lib_name = src[:-3]
            libs, ptxas = {}, {}
            for name, edits in {"full": [], **cuts}.items():
                dest = os.path.join(tmp, f"{kernel}_{name}")
                # each cut edits one file (a second call would recopy csrc/)
                (fname, pairs), = edits or [(src, [])]
                _build.edited_sources(dest, fname, pairs)
                _build.BUILD_INFO.pop(lib_name, None)
                libs[name] = _build.load(lib_name, dest)
                report = _build.BUILD_INFO.get(lib_name, {}).get("ptxas", "")
                ptxas[name] = sorted({ln.strip() for ln in report.splitlines()
                                      if "registers" in ln})
            real_load = mod.load
            times, accepted = {}, {}
            try:
                for name in list(libs) + list(libs)[::-1]:
                    mod.load = (lambda lib: lambda _name, *a: lib)(
                        libs[name])
                    if name not in times:
                        run()                                   # warm
                    t, a = run()
                    times.setdefault(name, []).append(t)
                    accepted[name] = a
            finally:
                mod.load = real_load
            out[key].update(source=src, ms=times, ptxas=ptxas)
            if kernel == "B4":
                out[key]["accepted"] = accepted
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return out


if __name__ == "__main__":
    if len(sys.argv) > 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else HERE)),
          flush=True)
