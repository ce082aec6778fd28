"""Split the time of B7's kernel (`csrc/klein_tc.cu`, Babai mode) between
its cross-block coupling, its serial rows and its sub-block products, at
the decode phase's shapes.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/babai_split.py

Builds four copies of the kernel source (`_build.edited_sources`, beside
the package's own libraries): as it is, without the cross-block coupling
(the tile holds minus the centres alone), without the rows (no row is
rounded: the products run on a tile that is never written), and without
the sub-block products. Each decodes 65,536 and 4,096 targets B x* + w on
NTRU-512 (dimension 1024, noise 0.45 min ||b*_i||), in turns full, the
cuts, the cuts reversed, full, timed by CUDA events after a warm-up.
Prints one JSON line with the times, the card, and ptxas's register
lines. The cut copies decode wrongly on purpose; they only time the
parts. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TARGETS = (65536, 4096)
RHO = 0.45
COUPLE = "couple<PASSES, false, WideY>(op, ysm, cacc, lo, warp, lane, wide);"
SUB = "sub_update<PASSES, WideY>(ad, ysm, ct, lo, sb, warp, lane, wide);"
CUTS = {
    "full": [],
    "no_coupling": [(COUPLE, "zero(cacc); if (lo < 0) " + COUPLE)],
    "no_rows": [(
        "for (int r2 = rlo + SB - 1; r2 > rlo; r2 -= 2) {",
        "for (int r2 = rlo + SB - 1; r2 > rlo && lo < 0; r2 -= 2) {")],
    "no_sub_update": [(SUB, "if (lo < 0) " + SUB)],
}


def main() -> dict:
    sys.path.insert(0, REPO)
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    ops = klein_cuda.babai_operands(lat.Q, lat.R)
    frag = klein_cuda.tc_fragments(ops)
    gen = torch.Generator(device="cuda").manual_seed(7)
    T = max(TARGETS)
    xs = torch.randint(-2, 3, (T, lat.n), device="cuda",
                       generator=gen).double()
    w = torch.randn(T, lat.n, device="cuda", generator=gen,
                    dtype=torch.float64)
    t = xs @ lat.basis.T + RHO * float(lat.gs_norms.min()) * w
    ct, _ = klein_cuda.babai_centres(ops, t)
    del xs, w, t
    cts = {B: ct[:, :B].contiguous() for B in TARGETS}
    libs, ptxas = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in CUTS.items():
            src = _build.edited_sources(os.path.join(tmp, name),
                                        "klein_tc.cu", edits)
            _build.BUILD_INFO.pop("klein_tc", None)
            libs[name] = _build.load("klein_tc", src)
            report = _build.BUILD_INFO.get("klein_tc", {}).get("ptxas", "")
            ptxas[name] = sorted({ln.strip() for ln in report.splitlines()
                                  if "registers" in ln})

    def run(lib, B):
        y = torch.empty_like(cts[B])
        bad = torch.zeros(2, dtype=torch.int32, device="cuda")
        p = _build.ptr
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        rc = lib.babai_tc_launch(
            p(frag), p(ops.UT), p(cts[B]), p(y), p(bad), ops.n_pad, B,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        b.record()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return a.elapsed_time(b)

    for lib in libs.values():
        run(lib, min(TARGETS))
    ms = {B: {} for B in TARGETS}
    for name in list(CUTS) + list(CUTS)[::-1]:
        for B in TARGETS:
            ms[B].setdefault(name, []).append(run(libs[name], B))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    return {"dim": lat.n, "rho": RHO,
            "ms": {f"{B}_targets": v for B, v in ms.items()},
            "card": card, "ptxas": ptxas}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
