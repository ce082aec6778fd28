"""Split the time of B2's kernel (`csrc/imhk_tc.cu`) between its cross-block
coupling and its draws, at the flagship's shapes.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/imhk_split.py [STEPS]

Builds three copies of the kernel source (`_build.edited_sources`, beside
the package's own libraries): as it is, without the cross-block coupling
(each block's coupling tile left at zero, so the draws still run, around
other centres, and the proposal still goes through the scratch), and
without the draws (only the coupling with its ring, the sub-block
products and the accept step run). Each is launched at 524,288 chains
(NTRU-512, sigma 165.7, window by tail budget 0.01) for STEPS fused steps
(default 8), in turns full, no coupling, no draws, no draws, no coupling,
full, timed by CUDA events after a one-step warm-up. Prints one JSON line
with the times, the card, and ptxas's register lines. The two cut copies
compute the wrong law on purpose; they only time the parts. Needs a CUDA
card.
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
CHAINS = 524288
SIGMA = 165.7
CUTS = {
    "full": [],
    "no_coupling": [(
        "couple_ring(op, tsm, rsm, ysc, ct, lo, warp, lane, tid);",
        "if (lo < 0) couple_ring(op, tsm, rsm, ysc, ct, lo, warp, lane, tid);"
        " else for (int k = tid; k < NC * CT_STRIDE; k += TPB) ct[k] = 0;")],
    "no_draws": [(
        "for (int r2 = rlo + SB - 1; r2 > rlo; r2 -= 2) {",
        "for (int r2 = rlo + SB - 1; r2 > rlo && lo < 0; r2 -= 2) {")],
}


def main(steps: int) -> dict:
    sys.path.insert(0, REPO)
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    from lattice_gaussian_mcmc_tpu_torch.utils.prng import seed_key
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    ops = klein_cuda.kernel_operands(
        klein_precompute(lat, SIGMA, tail_budget=0.01))
    y0, lw0 = klein_cuda.klein_draw(ops, CHAINS, seed=7)
    frag = klein_cuda.tc_fragments(ops)
    k0, k1 = seed_key(7)
    libs, ptxas, ms = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in CUTS.items():
            src = _build.edited_sources(os.path.join(tmp, name),
                                        "imhk_tc.cu", edits)
            _build.BUILD_INFO.pop("imhk_tc", None)
            libs[name] = _build.load("imhk_tc", src)
            report = _build.BUILD_INFO.get("imhk_tc", {}).get("ptxas", "")
            ptxas[name] = sorted({ln.strip() for ln in report.splitlines()
                                  if "registers" in ln})

    scratch = klein_cuda.proposal_scratch(ops.n_pad, CHAINS, "cuda")

    def run(lib, n_steps):
        x, lw = y0.clone(), lw0.clone()
        acc = torch.zeros_like(lw)
        bad = torch.zeros(2, dtype=torch.int32, device="cuda")
        p = _build.ptr
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        rc = lib.imhk_tc_launch(
            p(frag), p(ops.UT), p(ops.cs), p(ops.isg), None, p(x), p(lw),
            p(acc), None, None, None, None, p(scratch), p(bad), 1, ops.n_pad,
            CHAINS, ops.window, n_steps, k0, k1, 1, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        b.record()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return a.elapsed_time(b)

    for lib in libs.values():
        run(lib, 1)
    for name in list(CUTS) + list(CUTS)[::-1]:
        ms.setdefault(name, []).append(run(libs[name], steps))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    return {"steps": steps, "chains": CHAINS, "window": ops.window,
            "ms": ms, "card": card, "ptxas": ptxas}


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)),
          flush=True)
