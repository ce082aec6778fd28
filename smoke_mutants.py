#!/usr/bin/env python3
"""Check that `chip_smoke.py`'s kernel-vs-plain gates catch broken kernels.

    python3 smoke_mutants.py [NAME ...]

For each mutant below (or each one named), copies the checkout into a temporary directory,
breaks one file there, runs `chip_smoke.py` on the card and requires it to
fail in the phase named for that mutant: a kernel source of `csrc/` in its
`kernel_vs_plain` phase, a route of the Python package in the phase that
drives it, after the phases it must pass (for a fault that the kernels
and their plain versions share). Prints that phase's JSON line per mutant
and exits non-zero if a mutant got through. Needs a CUDA card; never touches the checkout itself.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    edited_sources,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("lattice_gaussian_mcmc_tpu_torch", "csrc")


def _tf32(v, c):
    return (f"{v}.{c} = __uint_as_float(__float_as_uint({v}.{c}) "
            "& 0xFFFFE000u);")


MUTANTS = {
    # B2 accepts every proposal
    "always_accept": ("imhk_tc.cu",
                      "const bool take = logf(u) < __fsub_rn(lwpf, lw);",
                      "const bool take = true;"),
    # B2/B3's coupling on U1 alone: one bf16 pass (hazard C2)
    "b2_hi_only": ("imhk_tc.cu", "constexpr int PASSES = PARTS;",
                   "constexpr int PASSES = 1;"),
    # B1/B6's coupling on U1 alone: one bf16 pass (hazard C2)
    "klein_tc_hi_only": ("klein_tc.cu", "constexpr int PASSES = PARTS;",
                         "constexpr int PASSES = 1;"),
    # klein.cu's FP32 coupling of B1, B6 and B7 above n_pad 3,456 reads U
    # with TF32's 10-bit mantissa (hazard C2)
    "tf32_coupling": ("klein_common.cuh", "const float4 u = __ldg(u4 + q);",
                      "float4 u = __ldg(u4 + q); "
                      + " ".join(_tf32("u", c) for c in "xyzw")),
    # B4 drops the reverse proposal term of its ratio (lw_rev = 0)
    "smk_no_reverse": ("smk_tc.cu",
                       "la = (float)((qc - qn) + (lwf - lwr));",
                       "la = (float)((qc - qn) + (lwf - 0.0));"),
    # B4's coupling (and its ct = U y) on U1 alone: one bf16 pass (C2)
    "smk_hi_only": ("smk_tc.cu", "constexpr int PASSES = PARTS;",
                    "constexpr int PASSES = 1;"),
    # B5 reads L2 with TF32's 10-bit mantissa: its lo part is dropped
    "tf32_peikert": ("peikert_tc.cu", "mma_tf32(dc[n], alo, bh[0], bh[1]);",
                     ""),
    # B5's 16-chain blocks (n_pad above 1,792) drop L2's lo part
    "peikert_wide_tf32": ("peikert_tc.cu",
                          "mma_tf32(dc[n], alo, bh[0], bh[1]);",
                          "if (NT == 4) mma_tf32(dc[n], alo, bh[0], bh[1]);"),
    # B5's product as the Pallas kernel's: both operands split into two
    # bf16 parts, hi.hi + hi.lo + lo.hi (hazard C9)
    "peikert_two_part": ("peikert_tc.cu",
                         "constexpr uint32_t KEEP = 0xFFFFE000u;",
                         "constexpr uint32_t KEEP = 0xFFFF0000u;"),
    # B7 rounds half away from zero (hazard C3)
    "babai_roundf": ("klein_tc.cu", "y = rintf(c);", "y = roundf(c);"),
    # B7's coupling to the rows decoded on U1 alone: one bf16 pass (C2)
    "b7_hi_only": ("klein_tc.cu", "couple<PASSES, false, WideY>(",
                   "couple<1, false, WideY>("),
    # B7 (and B1/B6's WIDE instantiations) without y's second and third
    # bf16 parts: no tile is flagged
    "b7_no_wide": ("klein_tc.cu", "big[i / SB] = 1;", "big[i / SB] = 0;"),
    # B2/B3's coupling drops the rows more than 1,024 above a block: no
    # change at n_pad 1024, wrong at FALCON-1024's 2048 (the NTRU-1024 check)
    "b2_near_rows_only": ("imhk_tc.cu",
                          "for (int kt = kt0; kt < KT; kt += 2) {",
                          "for (int kt = kt0; kt < min(KT, kt0 + 64); "
                          "kt += 2) {"),
    # B2's WIDE instantiation without them (fault C11; the q-ary check at
    # n = 64)
    "b2_no_wide": ("imhk_tc.cu", "big[i / SB] = 1;", "big[i / SB] = 0;"),
    # centred B1: every block of 32 chains draws around block 0's centres
    "centred_block0": ("klein_tc.cu",
                       "(size_t)ih * (size_t)B + (size_t)chain)",
                       "(size_t)ih * (size_t)B + (size_t)cl)"),
    # B6 draws every round on step 0's Philox counters
    "ring_one_step": ("klein_tc.cu",
                      "const uint32_t step = step0 + (uint32_t)rd;",
                      "const uint32_t step = step0;"),
    # ... and so does its FP32 route (n_pad above 3,456)
    "ring_one_step_fp32": ("klein.cu",
                           "const uint32_t step_r = step + (uint32_t)r;",
                           "const uint32_t step_r = step;"),
    # B8 counts cdf_k <= u total
    "zn_le": ("zn.cu", "idx += cdf[idx + s - 1] < target ? s : 0;",
              "idx += cdf[idx + s - 1] <= target ? s : 0;"),
    # B8's fourth draw of a group reads the third Philox word again
    "zn_same_word": ("zn.cu", "u[3] = mantissa_uniform(r.w);",
                     "u[3] = mantissa_uniform(r.z);"),
    # the points' kernel drops the top limb of two-limb tiles (Peikert's
    # and the signer's coefficients; IMHK's take one limb)
    "points_no_high_limb": ("points.cu",
                            "if (x1 >= a0 && x1 < a0 + P && x1 < la)",
                            "if (x1 >= a0 && x1 < a0 + P && x1 < la - 1)"),
}

# kernel mutants that must fail their phase in this one check of its
# `oks` alone
ONLY = {"points_no_high_limb": "points"}


# Mutants of the package's Python routes: (file, [(old, new), ...], the
# phase that must fail, the phases that must pass before it)
ROUTE_MUTANTS = {
    # fault R1: the blocked route runs B1's and B2's plain versions on the
    # card (the cli phase's launch counts)
    "r1_blocked_plain": (
        os.path.join("lattice_gaussian_mcmc_tpu_torch", "samplers",
                     "klein_blocked.py"),
        [("klein_cuda.klein_draw(ops,", "klein_cuda.klein_draw_plain(ops,"),
         ("klein_cuda.imhk_fused(ops,", "klein_cuda.imhk_fused_plain(ops,")],
        "cli", ()),
    # every rank runs chains from 0: the sharded paths drop the rank's
    # chain_offset (the mesh phase's two-rank digests)
    "mesh_no_offset": (
        os.path.join("lattice_gaussian_mcmc_tpu_torch", "parallel",
                     "collectives.py"),
        [("return chains.start, len(chains)", "return 0, len(chains)")],
        "mesh", ()),
    # the operands that B1/B2 and their plain versions share narrow the
    # last row's width by 1.25 at dimension >= 1024: kernel_vs_plain and
    # the 2D laws cannot see it, the float64 law at dimension 1024 can
    "operands_row_width": (
        os.path.join("lattice_gaussian_mcmc_tpu_torch", "ops", "kernels",
                     "klein_cuda.py"),
        [("isg=(1.0 / ppre.sigmas.to(torch.float64)).to(dtype),",
          "isg=(1.0 / ppre.sigmas.to(torch.float64) * torch.where("
          "(torch.arange(len(ppre.sigmas), device=ppre.sigmas.device) "
          "== n_real - 1) & (n_real >= 1024), 1.25, 1.0)).to(dtype),")],
        "scale_validation", ("kernel_vs_plain",)),
    # the signer returns its first draws: no redraw round, so the messages
    # above the bound keep their draw (the signing phase's tight bound)
    "sign_no_redraw": (
        os.path.join("lattice_gaussian_mcmc_tpu_torch", "samplers",
                     "sign.py"),
        [("                if idx.numel() == 0:\n",
          "                if True:\n")],
        "signing", ()),
    # the captured step's Philox counter does not advance: every replay of
    # a plain chain's graph draws the first step's numbers
    "graph_frozen_step": (
        os.path.join("lattice_gaussian_mcmc_tpu_torch", "utils", "graphs.py"),
        [("    step.add_(1)\n", "    step.add_(0)\n")],
        "captured_chains", ()),
}


def edit_file(path, edits):
    """Make the (old, new) `edits` in `path`, each old string found there
    exactly once."""
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit site not found once in {path}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def run_mutant(name, mutate, phase_name, must_pass=(), only=None):
    """Run the smoke on a copy of the checkout that `mutate(root)` broke;
    caught if it exits non-zero with `phase_name`'s own line not ok and
    the lines of the phases in `must_pass` ok; with `only`, that check of
    the phase's `oks` the only one failed."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "repo")
        shutil.copytree(REPO, root, ignore=shutil.ignore_patterns(
            ".git", "_build", "chiprun_out", "__pycache__"))
        mutate(root)
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                           capture_output=True, text=True, timeout=1200)
    lines = {}
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if "phase" in obj and "ok" in obj and "error" not in obj:
                lines[obj["phase"]] = obj
    phase = lines.get(phase_name)
    passed = {p: bool(lines.get(p, {}).get("ok")) for p in must_pass}
    caught = (r.returncode != 0 and phase is not None and not phase["ok"]
              and all(passed.values()))
    if only is not None and phase is not None:
        failed = sorted(k for k, v in phase.get("oks", {}).items() if not v)
        caught = caught and failed == [only]
    print(json.dumps({"mutant": name, "caught": caught, "rc": r.returncode,
                      phase_name: phase, "passed_before": passed}),
          flush=True)
    return caught


def main(names):
    known = set(MUTANTS) | set(ROUTE_MUTANTS)
    names = set(names) or known
    if names - known:
        raise SystemExit(f"unknown mutants: {sorted(names - known)}")
    caught = [run_mutant(name, lambda root, f=fname, e=[(old, new)]:
                         edited_sources(os.path.join(root, CSRC), f, e),
                         "kernel_vs_plain", only=ONLY.get(name))
              for name, (fname, old, new) in MUTANTS.items()
              if name in names]
    caught += [run_mutant(name, lambda root, p=path, e=edits:
                          edit_file(os.path.join(root, p), e), phase,
                          must_pass)
               for name, (path, edits, phase, must_pass)
               in ROUTE_MUTANTS.items() if name in names]
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
