#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from `lattice_gaussian_mcmc_tpu_torch/csrc/` and
drives the port's paths: the rows of the reference's flagship benchmark
(`bench.py`) on the NTRU-512 secret basis (dimension 1024), its benchmark
suite (`experiments/benchmark.py`, with the reduction rows), Babai / Gibbs
decoding, the CVP-decoding experiment, the Klein validation suite and the
convergence study. Phases, one JSON line each:

  toolchain        versions, the card, the kernel builds (one nvcc per
                   source, all started together)
  kernel_vs_plain  each kernel against its plain PyTorch version on the
                   card, on the caller's random numbers: B1 (Klein draw)
                   with its own centres against float64 and bit for bit
                   against B2's proposal at the same step, and above
                   n_pad 3,456 (klein.cu's FP32 route, with B6); B2
                   (fused IMHK) with the f32 conditional-centre error
                   against float64, of the plain version's centres and of
                   the kernel's own (its debug instantiation), B2 in
                   the 2D hard regime, where it rejects, and at
                   FALCON-1024's shape (NTRU-1024, n_pad 2048, window 24,
                   a chain count not a multiple of 32), where B3 is held
                   to B2 bit for bit too; B3 (IMHK
                   trajectory) bit for bit against B2 and against its
                   plain version; B4 (fused SMK) at the SMK row's operands,
                   its own forward and reverse centres against float64,
                   and decision by decision in the 2D hard regime; B5
                   (Peikert) at the Peikert row's operands, its own centres
                   against float64, and at NTRU-1024 (dimension 2048, 16
                   chains a block); B6 (Klein ring) round 0 and a
                   one-round ring bit for bit against B1, every round
                   against its plain version, its own centres against
                   float64; B7 (Babai) against its plain version, the
                   float64 nearest plane up to counted ties and x* at
                   noise 0.05, at half-integer 2D targets decision for
                   decision against its plain version, on a basis whose
                   coefficients pass 256 and 2^16 equal to float64 (its
                   wide parts), and above n_pad 3,456 (klein.cu's FP32
                   route); B8 (Z^n) against its plain version draw for
                   draw, on host uniforms and on Philox; B1, B2, B5 and
                   B6 on the suite's LLL-reduced q-ary operands at n = 16
                   and 64 (window 104, the WIDE instantiations: fault
                   C11), with the largest |y| each drew; centred B1 (a
                   centre per chain) at the signing width (n_pad 1024,
                   window 40) on the signer's residual centres, and bit
                   for bit against B1 with every centre equal; B1 and B2 at
                   the cli phase's shapes (Z^2048 at 2 eta, NTRU-512's
                   adaptation start, the crypto rows that sample); the
                   lattice points' int8 kernel (csrc/points.cu) bit for
                   bit against the float64 DGEMM at every cell's shape
                   and layout, its tile counts against the inputs'
  law              2D hard regime: TVD to the enumerated target and the
                   stationary acceptance 0.9904 (IMHK), TVD of SMK; B8's
                   TVD to the exact pmf; B6's per-round moments in 2D;
                   UnifiedLatticeSampler(klein) TVD at sigma 2
  signing          FalconSigner on NTRU-512 at FALCON-512's sigma, q and
                   floor(beta^2): 16 calls of 65,536 hashed messages,
                   every signature verified against the key's h, the mean
                   of ||s||^2 / (2n sigma^2), centred B1's largest |y|
                   (hazard C8), the redraw rounds a call, the ms a call,
                   and rows of a call held to the benchmark's float64
                   reference (lgbench/reference/sign.py)
  captured_chains  each plain chain function (imhk_chain, smk_chains,
                   gibbs_chain, annealed_gibbs_decode, _mhk_decode_batch)
                   as replays of one captured CUDA graph a step or sweep
                   (utils/graphs.py) bit for bit against its eager run,
                   on a short prefix at the drivers' shapes: replays and
                   ms a step of both; the 2D IMHK step's replay alone
  flagship         IMHKSampler.sample_iid at 524,288 chains, sigma 165.7,
                   64 fused steps per launch: samples/s, acceptance
  hard_regime      sigma = 0.45 max ||b*_i||, 131,072 chains: B3 trajectory
                   of 48 log-weights, pooled ACF and Sokal tau_int, a timed
                   64-step B2 run: samples/s, acceptance, ESS/s
  smk              SMKSampler at the same sigma, proposal 0.45 sigma,
                   131,072 chains, 32 steps: samples/s, acceptance, B4's
                   bound
  peikert          PeikertSampler at 1.05 r s1(B), 65,536 chains x 8
                   rounds in one launch: samples/s, second moment, B5's
                   bound
  scale_validation tools/validate_scale.py at dimension 1024: B1 + B2
                   (smooth and hard regimes), B1 + B4 (SMK) and B5
                   (Peikert) against the per-row float64 route on the card:
                   per-coordinate moments, the log-weight law (3 KS seeds
                   in the hard regime), acceptance, the float32 centre
                   error, Peikert's analytic covariance; one line a gate
  suite            run_benchmarks at its default dimensions 16, 64, 256
                   and 1024 (klein: B6, imhk: B1 + B2, direct: B8,
                   peikert: B5; 65,536 chains, 1 warm-up, 3 timed runs;
                   the native LLL/BKZ rows at 16, 64 and 256): one line
                   per row
  decode           B7 through Lattice.nearest_plane on NTRU-512, 65,536
                   targets B x* + w at noise 0.05 and 0.45 min ||b*_i||,
                   held to x* and to the float64 nearest plane; B7's
                   largest |y| and its FP32-route launches; the time of
                   the float64 centre products beside B7's; the f32-QR
                   centre count (hazard C7); annealed Gibbs through
                   UnifiedLatticeSampler.decode on NTRU-64
  decoding         experiments/decoding.py run_decoding at its defaults
                   (Babai: B7; Gibbs and MHK captured): gates, decodes/s
                   per method, B7 against the float64 nearest plane on
                   the same instances
  validation       klein_validation.run_suite (full budgets; B8) and
                   convergence_study.run_study at ConvergenceConfig's
                   defaults (50,000 draws), their chains captured:
                   all_passed and wall time
  cli              the port's CLI (experiments/cli.py main) at its
                   defaults on scaling (B1 draws up to Z^2048 at 65,536
                   chains, B2), crypto (B1 + B2 on the identity,
                   checkerboard, reduced q-ary and NTRU-64/256/512 rows),
                   sensitivity (B1 + B2) and adaptation (B1 start, B4
                   windows on NTRU-512 at 65,536 chains): exit 0, every
                   experiment's gates, its launch counts against the draws
                   and windows it made, and one line of its numbers
  mesh             the port of parallel/: world size 1 under NCCL, the
                   sharded flagship (B1 + 64 B2 steps, 524,288 chains)
                   and Peikert row (B5) equal bit for bit to the
                   unsharded routes; two gloo ranks on the card whose
                   gathered digests equal world size 1's; the CLI's mesh
                   experiment at its defaults; the dry run on 2 ranks;
                   klein_scaling (B1), the Ising and GMRF models, a
                   checkpoint round trip and the tables
  timing           B1 and B2 against their plain versions at the flagship
                   shapes, B6-B8 at the suite's and the decode phase's
                   shapes, and every kernel's bound: its bytes and each
                   type of its operations at the card's rate for that
                   type (`bound`), beside the FP32-only figure

Each path phase (captured_chains, flagship, hard_regime, smk, peikert,
scale_validation, suite, decode, signing, decoding, validation, each
experiment of cli, and each counted step of mesh) sets every launch count
(and the captured graphs' captures and replays) to 0 before it runs and
reads them after; decoding, validation and mesh require replays
(`captured`). Then the card's name and power limit, a `kernels` line, and
as the last line {"ok": true, "device": {...}}. Any failed check exits
non-zero before the last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP_CHAINS = 524_288
FLAGSHIP_REPS = 3
CHECK_CHAINS = 4096
FALCON_SIGMA = 165.7
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 on the CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# dense bf16 and TF32 on the tensor cores, and the special function units'
# exps (16 a clock per SM, 132 SMs, 1.98 GHz boost clock)
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12
PEAK_SFU_S = 16 * 132 * 1.98e9
# B8's generator work: integer instructions at the INT32 rate, 64 lanes a
# clock per SM (four partitions of 16, NVIDIA's Hopper architecture white
# paper), 132 SMs, 1.98 GHz boost clock
PEAK_INT32_S = 64 * 132 * 1.98e9
# Gates, kernel against its plain version on the same uniforms. The two sum
# the coupling in another order, so a CDF-boundary tie now and then flips a
# draw by one; every later row of that chain is then drawn around other
# centres. Each chain that differs must first differ by exactly one, and:
MAX_COEFF_SHARE = 1e-3       # integer coefficients that differ, of all
MAX_CHAIN_SHARE = 1e-2       # chains that differ anywhere, of all chains
# B2 at the flagship's depth (64 steps): a tie in any of 64 proposals may
# re-route the final state, so its chain share is held at 10%
MAX_CHAIN_SHARE_DEEP = 0.1
# accept decisions (acceptance counts) that differ, of all chains. On
# NTRU-512 the kernel rejects ~3e-5 of proposals, so this gate alone cannot
# tell a kernel that never rejects; the 2D hard regime (rejects ~1%) can.
MAX_ACCEPT_SHARE = 1e-3
# The flagship's 64 steps reject ~900 of 3.4e7 proposals. At sigma = 165.7
# log-weights hardly vary: lw is of order 10^3, where a float32 ulp is up
# to 1.2e-4, and lw' - lw is a few ulp, so a rejection needs u within ~1e-4
# of 1, and kernel and plain (whose lw may differ by one ulp) disagree on
# ~60 decisions (1.2e-4 of the chains). A kernel that never rejects changes
# ~1.7e-3 of the counts and has no rejections at all.
MAX_ACCEPT_SHARE_DEEP = 5e-4
MAX_REJECTION_GAP = 0.1      # |rejections - plain's| / plain's, 64 steps
# log-weights of chains that agree: sums of 1024 float32 log-normalizers in
# another order of the coupling sums (rounding only)
MAX_LW_ERR = 1e-3
MAX_CENTRE_ERR = 1e-3        # max_i |c_f32 - c_f64| / sigma_i
# B5's centres c = c' - L2 z against float64, max |c - c_f64| / r: at the
# Peikert row's operands the plain float32 product reads ~6e-4, the Pallas
# kernel's two-part bf16 split ~7e-3 (tests/test_torch_peikert_tc.py,
# ROADMAP C9)
MAX_PEIKERT_CENTRE_ERR = 2e-3
MAX_TVD = 0.02
HARD_SIGMA = 0.35
HARD_ACCEPTANCE = 0.9904     # enumerated stationary acceptance, 2D hard regime
# 131,072 chains x 12 steps: binomial noise ~8e-5, so 2e-3 still tells a
# sampler that never rejects (1.0) from the law
HARD_ACCEPTANCE_TOL = 2e-3
HARD_CHECK_CHAINS = 65_536   # B2 / B4 vs plain in the 2D hard regime
HARD_CHECK_STEPS = 4
SMK_2D_PROPOSAL = 0.35       # SMK's proposal width in the 2D hard regime
LAW_CHAINS = 131_072
LAW_STEPS = 12
# The bench rows (bench.py:136-296) at their own shapes. The acceptances
# are properties of the law at these sigmas, window policy and schedule:
# the reference's figures (BENCH_r05.json), held to +-0.01.
ROW_SIGMA_OVER_MAX_GS = 0.45
ROW_CHAINS = 131_072
HARD_T = 48                  # trajectory length (thin 1), lw ring only
HARD_MAX_LAG = HARD_T // 2
HARD_ROW_ACCEPTANCE = 0.794
SMK_STEPS = 32
SMK_PROPOSAL_OVER_SIGMA = 0.45
SMK_ROW_ACCEPTANCE = 0.595
ROW_ACCEPTANCE_TOL = 0.01
PEIKERT_CHAINS = 65_536
PEIKERT_ROUNDS = 8
PEIKERT_SIGMA_OVER_RS1 = 1.05
PEIKERT_WINDOW = 24          # suggest_peikert_window(r, 1024), budget 0.01
MAX_NORM_GAP = 0.02          # |E||Bx||^2 / (dim sigma^2) - 1|
B3_CHECK_KEEP, B3_CHECK_THIN = 3, 2
B4_CHECK_STEPS = 2
B5_CHECK_ROUNDS = 2
B6_CHECK_ROUNDS = 3
KLEIN_ROW_SIGMA_OVER_MAX_GS = 1.3   # the suite's klein and imhk rows
# B7: a target whose decode differs from the float64 nearest plane must
# first differ (in its highest coordinate, decoded first) where the float64
# pre-rounding value lies within this of a half-integer: a tie at float32
# resolution of the 1024-term coupling sums (measured on NTRU-512: at most
# 3.0e-6 away, 10 such targets of 8,192)
BABAI_TIE_TOL = 1e-4
DECODE_TARGETS = 65_536
DECODE_RHOS = (0.05, 0.45)           # noise / min ||b*_i||
DECODE_CHECK = 4096                  # targets held to the float64 oracle
GIBBS_TARGETS, GIBBS_CHAINS, GIBBS_SWEEPS = 64, 24, 48
# annealed Gibbs on NTRU-64 at the high noise and at one where Babai's
# success lies strictly between 0 and 1 (prod_i erf(R_ii / (2 sqrt(2) rho
# min_gs)) = 0.45 at 0.22), so that the two success rates can part
GIBBS_RHOS = (0.22, 0.45)
# B7's reach in y: an upper-triangular integer basis with a unit diagonal
# (its own R, Q = I), built so that the recentred coefficients y pass 256
# and 2^16 (with more than 16 significant bits, so that y's third bf16
# part is not 0) while every quantity of the decode is an integer or a
# quarter below 2^22, exact in float32: the kernel must equal float64
# coefficient for coefficient (`reach_basis`)
REACH_N = 256
REACH_TARGETS = 512
# B7's cost where tiles are flagged: the reach basis's operands at this
# many targets, on centres that pass 256 and on centres that do not
REACH_TIMING_TARGETS = 65536
# B7 above the tensor-core reach: targets B x* + w on the FP32 route's
# basis, w ~ N(0, 0.05^2) against R_ii >= 1
FP32_ROUTE_TARGETS = 256
FP32_ROUTE_NOISE = 0.05
# B8: the kernel repeats its plain version's CDF bit for bit, so every draw
# is equal on the same uniforms
ZN_SIGMA = 5.0                       # the suite's direct row
ZN_BOUNDARY = 65_536                 # check uniforms exactly on a CDF entry
ZN_LAW_DRAWS = 1 << 22
LAW_2D_CHAINS = 1 << 20              # UnifiedLatticeSampler(klein), sigma 2
B6_MOMENT_CHAINS = 65_536
B6_STD_TOL = 0.02                    # |std / (sigma sqrt(diag(G^-1))) - 1|
SUITE_CHAINS = 65_536                # the suite's default n_chains
# B1, B2, B5 and B6 on the suite's rows below 256: the LLL-reduced
# `qary_lattice(n, n/2, q=3329, seed 42)` at sigma 1.5 max ||b*_i||
# (window 24 at n = 16, 104 at n = 64, n_pad 128 for both); at n = 64 ~5%
# of the coefficients pass 256, so B1, B2 and B6 take their WIDE
# instantiations (fault C11)
QARY_DIMS = (16, 64)
QARY_SEED = 42
QARY_CHAINS = 4096
QARY_STEPS = 4
QARY_ROUNDS = 3
# the convergence study's draws: ConvergenceConfig's default, now that its
# chains run as captured graphs (they took 381 s of a smoke run eagerly)
CONVERGENCE_SAMPLES = 50_000
# captured_chains: each plain chain function against its eager run on a
# short prefix at the drivers' shapes
CAPTURED_SIGMA = 0.35                # klein_validation's 2D hard regime
CAPTURED_2D_STEPS = 256
CAPTURED_SMK = (8, 64)               # chains, steps
CAPTURED_GIBBS_CHAIN = (24, 8)       # chains, sweeps at n = 64
CAPTURED_ANNEALED = (64, 24, 4)      # targets, chains, sweeps at n = 64
CAPTURED_MHK = (64, 8)               # targets, steps at n = 128
CAPTURED_RHO = 0.35                  # run_decoding's middle noise
CAPTURED_REPLAYS = 1000              # 2D IMHK replays timed alone
# B1 and B6 above the tensor-core sweep's reach (klein_cuda's
# KLEIN_TC_MAX_N_PAD, 3,456) run klein.cu's FP32 sweep: checked on an
# upper-triangular basis of dimension 3,500 (n_pad 3,584), diagonal in
# [1, 2] and entries above it in [-0.05, 0.05] (so ||B^-1|| ~ 4 and the
# coefficients stay small), at sigma 4 (window 40)
FP32_ROUTE_N = 3500
FP32_ROUTE_CHAINS = 512
FP32_ROUTE_SIGMA = 4.0
FP32_ROUTE_ROUNDS = 2
# B5 at NTRU-1024 (dimension 2048: n_pad above 1,792, 16 chains a block),
# bench.py's Peikert row at BENCH_N = 1024
PEIKERT_WIDE_RING = 1024
# B2 and B3 at FALCON-1024's signing shape (NTRU-1024, sigma 168.3886,
# tail budget 0.01: n_pad 2048, window 24), the falcon1024.imhk_smooth
# benchmark cell's operands, on a chain count that leaves the last block
# of 32 chains part empty
B2_NTRU1024_RING = 1024
FALCON1024_SIGMA = 168.3886
B2_NTRU1024_CHAINS = CHECK_CHAINS - 3
# FALCON-512 signing (samplers/sign.py, the falcon512_sign benchmark
# configuration): sigma, q, floor(beta^2) and the signing tail budget
# 2^-64, whose window is 40 on NTRU-512 (centred B1's compiled window)
SIGN_SIGMA, SIGN_Q, SIGN_BETA2 = 165.7366, 12289, 34034726
SIGN_TAIL = 2.0 ** -64
SIGN_WINDOW = 40
SIGN_MESSAGES = 65_536
SIGN_CALLS = 16                      # 2^20 signatures
# |E ||s||^2 / (2n sigma^2) - 1| over the 2^20 signatures: ~4e-5 of noise
# (a signature's relative spread, 0.044, over 1024); the bound's cut takes
# 3.9e-6 of them
MAX_SIGN_NORM_GAP = 2e-3
SIGN_REF_ROWS = 256                  # rows held to the float64 reference
# the redraw loop at scale: floor(beta^2) at 2n sigma^2, about the median
# of ||s||^2, fails about half of each round's draws
SIGN_TIGHT_MESSAGES = 4096
SIGN_TIGHT_MIN_ROUNDS = 3
# the falcon512_sign.batch cell's limit on rows that differ from it
SIGN_MAX_ROWS_DIFFER = 0.05
# the points' int8 kernel (csrc/points.cu): rows of the IMHK cells'
# calls at dimension 1024 and 2048, |x| of the random coefficients at
# 2048 (IMHK's reach ~50), ms as the median of this many launches, and
# the int8 tensor cores' dense peak (NVIDIA data sheet)
POINTS_IMHK_ROWS = (FLAGSHIP_CHAINS, 131_072)
POINTS_IMHK_TOP = 60
POINTS_REPS = 5
PEAK_INT8_S = 1979e12
# the cli phase: the port's CLI at its defaults, these experiments
CLI_EXPERIMENTS = ("scaling", "crypto", "sensitivity", "adaptation")
# the mesh phase: the sharded paths (parallel/) at the flagship's and the
# Peikert row's shapes at world size 1 under NCCL, two gloo ranks on the
# card on half of RANK_CHAINS each (Peikert RANK_ROUNDS rounds a chain),
# the CLI's mesh experiment, the dry run on 2 ranks and the modules with
# no kernel of their own
MESH_SEED = 11
RANK_CHAINS = 65_536
RANK_ROUNDS = 2
RANK_TIMEOUT_S = 300
KLEIN_SCALING_DIMS = (16, 32, 64, 128)
KLEIN_SCALING_SAMPLES = 50_000
KLEIN_SCALING_SEED = 42
ISING_SHAPE = (1024, 1024)
ISING_SWEEPS = 200
ISING_BETA = 0.44
GMRF_GRID = (64, 64)
GMRF_SAMPLES = 256
MAX_GMRF_QUAD_GAP = 0.01     # |E x^T Q x / n - 1|, x ~ N(0, Q^-1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, why):
    emit({"phase": phase, "ok": False, "error": why})
    sys.exit(1)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(fn, reps=1):
    """Mean device time of fn() over reps, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_draws(y, yp, lw, lwp, n, among=None, lw_among=None):
    """Kernel vs plain on chain-minor draws (n_pad, B): the share of integer
    coefficients that differ, the share of chains that differ, whether each
    such chain (of those in the mask `among`) first differs, in its highest
    row, drawn first, by exactly one, and max |lw err| over the chains that
    agree (and lie in the mask `lw_among`)."""
    import torch
    diff = y[:n] != yp[:n]                    # (n, B)
    chains = diff.any(dim=0)
    ties_ok = True
    tied = chains if among is None else chains & among
    if bool(tied.any()):
        idx = torch.nonzero(tied).squeeze(1)
        rows = torch.arange(n, device=y.device)[:, None]
        first = torch.where(diff[:, idx], rows, -1).max(dim=0).values
        step = (y[first, idx] - yp[first, idx]).abs()
        ties_ok = bool((step == 1).all())
    same = ~chains if lw_among is None else ~chains & lw_among
    lw_err = float((lw[same] - lwp[same]).abs().max()) if bool(same.any()) \
        else float("nan")
    return {"coeffs_differing": float(diff.float().mean()),
            "chains_differing": float(chains.float().mean()),
            "ties_off_by_one": ties_ok, "max_abs_lw_err": lw_err}


def compare_steps(x, xp, lx, lxp, ax, axp, n, n_steps, lw_among=None):
    """compare_draws on B2's final states, plus its accept decisions: the
    share of chains whose acceptance counts differ, how many of the chains
    that agree in state differ in count, and the rejections on each side.
    A chain whose decisions differ holds another proposal altogether, so
    the off-by-one test covers the chains whose counts agree."""
    res = compare_draws(x, xp, lx, lxp, n, among=ax == axp,
                        lw_among=lw_among)
    same = (x[:n] == xp[:n]).all(dim=0)
    B = x.shape[1]
    res.update(
        accept_differing=float((ax != axp).float().mean()),
        accept_differing_agreeing=int((ax[same] != axp[same]).sum()),
        rejections=int(round(B * n_steps - float(ax.double().sum()))),
        rejections_plain=int(round(B * n_steps - float(axp.double().sum()))))
    return res


def fused_vs_plain(ops, y, lw, n_steps, gen):
    """B2 and its plain version, n_steps from the state (y, lw) on the
    same caller's uniforms; compare_steps of the two."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
    B = y.shape[1]
    u = torch.rand(n_steps * (ops.n_pad + klein_cuda.ACCEPT_ROWS), B,
                   device=y.device, generator=gen)
    x, lx, ax = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lxp, axp = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, lx, ax, n_steps, uniforms=u)
    klein_cuda.imhk_fused_plain(ops, xp, lxp, axp, n_steps, uniforms=u)
    torch.cuda.synchronize()
    return compare_steps(x, xp, lx, lxp, ax, axp, ops.n, n_steps)


def smk_vs_plain(ops, y, n_steps, gen):
    """B4 and its plain version, n_steps from the state y on the same
    caller's uniforms; compare_steps of the final states, with the last
    step's log alpha in place of lw, held on the chains that agree and
    accepted every step (their last proposal is their final state). Also
    the two device times of the runs."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import smk_cuda
    B = y.shape[1]
    u = torch.rand(n_steps * (ops.n_pad + smk_cuda.ACCEPT_ROWS), B,
                   device=y.device, generator=gen)
    x, ax = y.clone(), torch.zeros(B, device=y.device)
    xp, axp = y.clone(), torch.zeros(B, device=y.device)
    out, outp = [], []
    ms = cuda_ms(lambda: out.extend(
        smk_cuda.smk_steps(ops, x, ax, n_steps, uniforms=u)))
    plain_ms = cuda_ms(lambda: outp.extend(
        smk_cuda.smk_steps_plain(ops, xp, axp, n_steps, uniforms=u)))
    res = compare_steps(x, xp, out[2], outp[2], ax, axp, ops.n, n_steps,
                        lw_among=(ax == n_steps) & (axp == n_steps))
    res["max_abs_log_alpha_err"] = res.pop("max_abs_lw_err")
    return res, ms, plain_ms


def smk_centre_err(sampler, y):
    """B4's debug instantiation, one step from the state y (n_pad, B): the
    largest error of its forward centres c_i = (U y)_i - (U y')_i + y'_i
    and reverse centres c'_i = (U y')_i - (U y)_i + y_i against float64
    from the target's float64 U, over the proposal widths."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import smk_cuda
    ops = sampler.operands
    c, cp, p = smk_cuda.smk_centres(ops, y.clone(), seed=33, step=1)
    n = ops.n
    U = sampler._target_pre.U.double()
    ya, pa = y[:n].double(), p[:n].double()
    uy, up = U @ ya, U @ pa
    sp = 1.0 / ops.isgp[:n].double()[:, None]
    return max(float(((c[:n].double() - (uy - up + pa)).abs() / sp).max()),
               float(((cp[:n].double() - (up - uy + ya)).abs() / sp).max()))


def draws_ok(res, max_chains=MAX_CHAIN_SHARE):
    return (res["coeffs_differing"] <= MAX_COEFF_SHARE
            and res["chains_differing"] <= max_chains
            and res["ties_off_by_one"]
            and res["max_abs_lw_err"] <= MAX_LW_ERR)


def hard_decisions_ok(res, chains):
    """In the 2D hard regime: the draws agree up to ties, the kernel
    rejects, every decision on a chain that agrees is the plain version's,
    and the rejection totals differ by no more than the tie-routed chains."""
    n_tied = round(res["chains_differing"] * chains)
    return (res["coeffs_differing"] <= MAX_COEFF_SHARE
            and res["chains_differing"] <= MAX_CHAIN_SHARE
            and res["ties_off_by_one"] and res["rejections"] > 0
            and res["accept_differing_agreeing"] == 0
            and res["accept_differing"] <= MAX_ACCEPT_SHARE
            and abs(res["rejections"] - res["rejections_plain"]) <= n_tied)


def compare_rings(ring, ringp):
    """B5 against its plain version: coordinates are independent draws, so
    a tie moves one coordinate by one and nothing else."""
    diff = ring != ringp
    step = (ring[diff] - ringp[diff]).abs()
    return {"coeffs_differing": float(diff.float().mean()),
            "ties_off_by_one": bool((step == 1).all()),
            "max_abs_err": float(step.max()) if step.numel() else 0.0}


def fp32_bound_ms(flop, nbytes):
    """Every operation at the CUDA cores' FP32 rate, or the bytes, the
    larger: the bound of PRs 1-6, kept beside `bound` for comparison."""
    return 1e3 * max(flop / PEAK_FP32_S, nbytes / PEAK_BYTES_S)


def bound(nbytes, tensor=0, tensor_peak=PEAK_BF16_S, special=0, fp32=0,
          int32=0):
    """The least time the card could take for a kernel's work: its bytes
    (inputs read once, outputs written once) over the memory rate, and
    each type of operation over its unit's peak: the products on the
    tensor cores (bf16 unless `tensor_peak` says otherwise), exps and
    other special functions on the SFUs, FP32 and INT32 operations on the
    CUDA cores. The units run side by side, so the bound is the largest
    part."""
    parts = {"bytes": 1e3 * nbytes / PEAK_BYTES_S,
             "tensor_cores": 1e3 * tensor / tensor_peak,
             "sfu": 1e3 * special / PEAK_SFU_S,
             "fp32": 1e3 * fp32 / PEAK_FP32_S,
             "int32": 1e3 * int32 / PEAK_INT32_S}
    ms = max(parts.values())
    return {"bound_ms": ms,
            "bound_by": "bytes" if parts["bytes"] >= ms else "operations",
            "bound_parts_ms": parts}


def klein_bound(n, window, proposals, nbytes):
    """B1-B3's and B6's for `proposals` Klein draws: the coupling's n(n-1)
    FLOP three times (one bf16 pass per part of U), the n W exps, and the
    rest of `klein_flop` (5 n W) in FP32."""
    return bound(nbytes, tensor=3 * n * (n - 1) * proposals,
                 special=n * window * proposals,
                 fp32=5 * n * window * proposals)


def smk_bound(n, window, proposals, chains, nbytes):
    """B4's: B1's coupling, two windows of exps a row (the draw's and the
    reverse normaliser's), the rest of `smk_flop` in FP32, and n(n+1) FP32
    FLOP a chain once."""
    return bound(nbytes, tensor=3 * n * (n - 1) * proposals,
                 special=2 * n * window * proposals,
                 fp32=(9 * n * window + 8 * n) * proposals
                 + n * (n + 1) * chains)


def peikert_bound(n, window, draws, nbytes):
    """B5's for `draws` chain-rounds: L2 z's n(n+1) FLOP three times
    (3xTF32) on the tensor cores, the n W exps and Box-Muller's four
    special functions a pair of normals, and the rest of `peikert_flop`
    (~3 n for Box-Muller, 5 n W for the rounding) in FP32."""
    return bound(nbytes, tensor=3 * n * (n + 1) * draws,
                 tensor_peak=PEAK_TF32_S,
                 special=(n * window + 2 * n) * draws,
                 fp32=(3 * n + 5 * n * window) * draws)


def klein_flop(n, window):
    # coupling: n(n-1)/2 FMAs (2 FLOP each); per row and window entry two
    # multiplies, an add, the exp, the CDF add and the compare
    return n * (n - 1) + 6 * n * window


def smk_flop(n, window):
    # per step: a Klein sweep, then per row and window entry of the reverse
    # normaliser two multiplies, an add, the exp and the sum, and per row
    # the reverse centre and the two target quadratics (8)
    return klein_flop(n, window) + 5 * n * window + 8 * n


def peikert_flop(n, window):
    # per round: L2 z over the lower triangle with its diagonal, n(n+1)/2
    # FMAs; Box-Muller, ~10 operations per pair of normals; the rounding
    # of every row as in klein_flop
    return n * (n + 1) + 5 * n + 6 * n * window


def tvd_2d(X, basis2, sigma):
    """TVD of 2D coefficient draws X (B, 2) to the enumerated D_{L,sigma}
    on the box |x_i| <= 8, the mass outside the box counted as error."""
    import torch
    dev = X.device
    r = torch.arange(-8, 9, dtype=torch.float64, device=dev)
    grid = torch.cartesian_prod(r, r)          # row (a+8)*17 + (b+8)
    pts = grid @ torch.tensor(basis2, dtype=torch.float64, device=dev).T
    p = torch.softmax(-0.5 * (pts ** 2).sum(1) / sigma ** 2, dim=0)
    inside = (X.abs() <= 8).all(dim=1)
    Xi = X[inside].long() + 8
    emp = torch.bincount(Xi[:, 0] * 17 + Xi[:, 1], minlength=17 * 17)
    emp = emp.double() / X.shape[0]
    return 0.5 * float((emp - p).abs().sum() + (1 - inside.double().mean()))


def tvd_1d(z, sigma, center):
    """TVD of draws z to the exact pmf of D_{Z,sigma,center}, the mass
    outside its support counted as error."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
        exact_pmf,
    )
    support, p = exact_pmf(sigma, center)
    zi = z.reshape(-1).long() - int(support[0])
    inside = (zi >= 0) & (zi < len(support))
    emp = torch.bincount(zi[inside], minlength=len(support)).double()
    emp = emp.cpu().numpy() / zi.numel()
    return 0.5 * float(abs(emp - p).sum() + (1.0 - emp.sum()))


def zn_bound(num):
    """B8's bound for num draws: 4 bytes written a draw, and a quarter of
    a Philox call's integer instructions (counted in the SASS) a draw at
    the INT32 rate; with the instruction count."""
    from lattice_gaussian_mcmc_tpu_torch.tools import sass
    per_call = sass.philox_instructions()
    return {**bound(4 * num, int32=per_call / 4 * num),
            "philox_sass_instructions": per_call}


def decode_targets(lat, T, rho, gen):
    """(x* uniform in [-2, 2]^n, t = B x* + w with w ~ N(0, (rho
    min ||b*_i||)^2) per coordinate), float64 on the lattice's device."""
    import torch
    n, dev = lat.n, lat.basis.device
    xs = torch.randint(-2, 3, (T, n), device=dev, generator=gen).double()
    w = torch.randn(T, n, device=dev, generator=gen, dtype=torch.float64)
    return xs, xs @ lat.basis.T + (rho * float(lat.gs_norms.min())) * w


def f32_qr_centres(lat, t):
    """ct = (t Q) / diag(R) from a float32 QR of the basis on the card, as
    `babai_decode_batch_pallas` forms it (hazard C7; (t q_i) / r_ii does
    not depend on the QR's signs)."""
    import torch
    Q, R = torch.linalg.qr(lat.basis.float())
    return (t.float() @ Q) / torch.diagonal(R)


def decode_from_centres(kc, ops, ct):
    """Coefficients (B, n) float64 that B7 decodes from the given centres
    ct (B, n) instead of the lattice's float64 ones."""
    centred, k = kc.babai_recentre(ops, ct)
    return kc.babai_decode(ops, centred)[:ops.n].T.double() + k


def babai_ties(lat, t, X, Xo):
    """Targets whose decode X differs from the float64 nearest plane Xo,
    and the largest distance to a half-integer of the float64 pre-rounding
    value c_i = ct_i - sum_{j>i} U_ij x_j at each one's first differing
    coordinate (the highest, decoded first; above it both agree)."""
    import torch
    diff = X != Xo
    bad = diff.any(dim=1)
    if not bool(bad.any()):
        return 0, 0.0
    idx = torch.nonzero(bad).squeeze(1)
    R = lat.R.double()
    r = torch.diagonal(R)
    x = Xo[idx].double()
    c = (t[idx].double() @ lat.Q.double()) / r - x @ (R / r[:, None]).T + x
    rows = torch.arange(lat.n, device=X.device)[None, :]
    first = torch.where(diff[idx], rows, -1).max(dim=1).values
    cf = c[torch.arange(len(idx), device=X.device), first]
    return int(bad.sum()), float(((cf - torch.floor(cf)) - 0.5).abs().max())


class Smoke:
    """The shared objects of one run and the numbers the `kernels` line
    reports."""

    def __init__(self):
        import torch
        sys.path.insert(0, REPO)
        from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
        from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
            klein_cuda,
            launch_record,
            peikert_cuda,
            points_cuda,
            smk_cuda,
            zn_cuda,
        )
        from lattice_gaussian_mcmc_tpu_torch.utils import graphs
        self.kc, self.sc, self.pc = klein_cuda, smk_cuda, peikert_cuda
        self.zc, self.ptc, self.rec = zn_cuda, points_cuda, launch_record
        self.graphs = graphs
        # the plain versions' matrix products run in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = torch.device("cuda", 0)
        self.card = nvidia_smi_line()
        self.lat = ntru_lattice(512, q=12289, seed=0,
                                cache_dir=os.path.join(REPO, "bench_cache"),
                                device=self.dev)
        self.gen = torch.Generator(device=self.dev).manual_seed(1234)
        self.sigma_row = ROW_SIGMA_OVER_MAX_GS * float(
            self.lat.gs_norms.max())
        self.launches = {}       # path phase -> launch counts
        self.k = {}              # kernel -> numbers for the kernels line

    def reset_counts(self):
        self.rec.reset()
        self.graphs.reset_counts()

    def counts(self):
        """The launch record's launches of each kernel, and those of
        klein.cu's FP32 sweep as `<kernel>_fp32`."""
        out = {}
        for k, r in self.rec.read().items():
            out[k], out[f"{k}_fp32"] = r["launches"], r["fp32_launches"]
        return out

    def wide_launches(self):
        """The launch record's WIDE launches, summed over the kernels."""
        return sum(r["wide_launches"] for r in self.rec.read().values())

    def max_y(self, kernel):
        """The largest |y| the launch record holds for `kernel`."""
        return self.rec.read()[kernel]["max_abs_y"]

    def graph_counts(self):
        """The plain chains' captured graphs (utils/graphs.py) since the
        last `reset_counts`: captures, replays and the captures' host
        seconds."""
        g = self.graphs.StepGraph
        return {"captures": g.captures, "replays": g.replays,
                "capture_s": g.capture_s}

    def note(self, kernel, **kw):
        self.k.setdefault(kernel, {}).update(kw)

    def hard_operands(self):
        from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
        pre = klein_precompute(self.lat, self.sigma_row, tail_budget=0.01)
        return pre, self.kc.kernel_operands(pre)

    def peikert_sigma(self):
        """(sigma, r, s1(B)) of the Peikert row: sigma = 1.05 r s1(B)."""
        if not hasattr(self, "_peikert"):
            import numpy as np
            from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
                smoothing_parameter_zn,
            )
            s1 = float(np.linalg.norm(
                self.lat.basis.cpu().double().numpy(), 2))
            r = smoothing_parameter_zn(self.lat.n, 0.01)
            self._peikert = (PEIKERT_SIGMA_OVER_RS1 * r * s1, r, s1)
        return self._peikert


# ---------------------------------------------------------------- toolchain
def phase_toolchain(s: Smoke):
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in ("klein", "klein_tc", "imhk_tc", "smk_tc", "peikert_tc",
                 "zn", "sign", "points"):
        _build.load(name)
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln][:12]
             for name, info in _build.BUILD_INFO.items()}
    # B2/B3's kernel at n_pad 1024 for the paths' windows, and at 2048 for
    # FALCON-1024's: registers, spills, shared memory, and the blocks and
    # chains resident per SM
    imhk_tc = {f"window_{w}": s.kc.imhk_tc_resources(1024, w)
               for w in (16, 8, 24)}
    imhk_tc["n_pad_2048_window_24"] = s.kc.imhk_tc_resources(2048, 24)
    smk_tc = {f"window_{w}": s.sc.smk_tc_resources(1024, w)
              for w in (8, 16, 24)}
    # B1's and B6's (klein_tc.cu) at n_pad 256 and 1024
    klein_tc = {f"n_pad_{n}": {f"{k}_window_{w}": s.kc.klein_tc_resources(
        n, w, k) for k in ("b1", "b6") for w in (8, 16, 24)}
        for n in (256, 1024)}
    # centred B1's at the signing width (n_pad 1024, window 40)
    klein_tc["n_pad_1024"]["b1_centred_window_40"] = \
        s.kc.klein_tc_resources(1024, SIGN_WINDOW, "b1_centred")
    # B7's (klein_tc.cu, Babai mode) at the decode phase's and the reach
    # check's n_pad, and at the largest the route takes
    for n in (256, 1024, s.kc.KLEIN_TC_MAX_N_PAD):
        klein_tc.setdefault(f"n_pad_{n}", {})["b7"] = \
            s.kc.klein_tc_resources(n, 1, "b7")
    # the suite's q-ary rows (n_pad 128): window 24 at n = 16, and the
    # WIDE instantiations at window 104, n = 64 (fault C11)
    qary = {"n16_window_24": {
                "b1": s.kc.klein_tc_resources(128, 24, "b1"),
                "b6": s.kc.klein_tc_resources(128, 24, "b6"),
                "b2": s.kc.imhk_tc_resources(128, 24)},
            "n64_window_104_wide": {
                "b1": s.kc.klein_tc_resources(128, 104, "b1_wide"),
                "b6": s.kc.klein_tc_resources(128, 104, "b6_wide"),
                "b2": s.kc.imhk_tc_resources(128, 104, wide=True)}}
    emit({"phase": "toolchain", "ok": True, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1] if nvcc else None,
          "triton": has_triton, "card": s.card, "build_s": build_s,
          "build_s_each": built, "ptxas": ptxas,
          "imhk_tc_resources": imhk_tc, "smk_tc_resources": smk_tc,
          "klein_tc_resources": klein_tc, "qary_tc_resources": qary})


# ------------------------------------------------------------- points
def median_ms(fn, reps=POINTS_REPS):
    """Median device time of fn() over `reps` launches, each by CUDA
    events."""
    return sorted(cuda_ms(fn) for _ in range(reps))[reps // 2]


def points_case(s: Smoke, limbs, basis, x):
    """The kernel on coefficients x against the float64 DGEMM of the same
    x (the cast and product it replaces): bit for bit, the launch's
    change of `limb_stats` against the tiles' limb counts, both ms, the
    bound."""
    import torch
    ptc = s.ptc
    before = ptc.limb_stats()
    got = ptc.points(limbs, x)
    stats = {k: v - before[k] for k, v in ptc.limb_stats().items()}
    want = x.to(torch.float64) @ basis.T
    equal = torch.equal(got, want)
    expected_stats = ptc.limb_counts(x)
    del got, want
    rows, n = x.shape
    ms = median_ms(lambda: ptc.points(limbs, x))
    lib_ms = median_ms(lambda: x.to(torch.float64) @ basis.T)
    la = ptc.tile_limbs(x)
    # products: 2 n (multiply-adds) a row and output column for each limb
    # pair of each tile's limbs; bytes: x read once, P written once
    pairs = float(la.sum()) * limbs.n_limbs
    ops = 2 * pairs * ptc.TILE_ROWS * ptc.TILE_COLS * n
    nbytes = x.numel() * x.element_size() + 8 * rows * n
    return {"shape": [rows, n], "dtype": str(x.dtype).split(".")[-1],
            "strides": list(x.stride()), "basis_limbs": limbs.n_limbs,
            "bit_for_bit": equal, "limb_stats": stats,
            "limb_stats_ok": stats == expected_stats, "ms": ms,
            "dgemm_ms": lib_ms, **bound(nbytes, tensor=ops,
                                        tensor_peak=PEAK_INT8_S)}


def check_points(s: Smoke):
    """The int8 kernel of the lattice points (`csrc/points.cu`) against
    the float64 DGEMM of the same coefficients, bit for bit (torch.equal),
    at every cell's shape and layout: Peikert's float32 ring view (65,536
    draws of B5 at the Peikert row), the signer's float64 x.T (65,536
    messages at the signing width; a one- and a three-message redraw
    batch), IMHK's row-major float32 coefficients at dimension 1024 (B1's
    524,288 draws at FALCON-512's sigma) and 2048 (131,072 rows, |x| <=
    POINTS_IMHK_TOP, on NTRU-1024's key); `limb_stats` against the tiles
    of each input; the kernel's ms beside the DGEMM's."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        FalconSigner,
        PeikertSampler,
        klein_precompute,
    )
    kc, dev, gen = s.kc, s.dev, s.gen
    basis = s.lat.basis
    cases = {}
    sigma, _, _ = s.peikert_sigma()
    ps = PeikertSampler(s.lat, sigma)
    x = ps.sample(31, PEIKERT_CHAINS, return_coeffs=True)
    cases["peikert"] = points_case(s, ps.limbs, basis, x)
    del x
    signer = FalconSigner(s.lat, SIGN_SIGMA, SIGN_Q, SIGN_BETA2,
                          tail_budget=SIGN_TAIL)
    c = signer.hash_to_point(37, SIGN_MESSAGES).to(torch.float64)
    x0, cs = signer.centres(c)
    y, _ = kc.klein_draw_centred(signer.operands, cs, seed=37, step=0)
    x = x0 + y[:x0.shape[0]]
    del x0, cs, y, c
    cases["sign"] = points_case(s, signer._limbs, basis, x.T)
    for m in (1, 3):
        cases[f"sign_redraw_{m}"] = points_case(
            s, signer._limbs, basis, x[:, :m].contiguous().T)
    del x
    pre = klein_precompute(s.lat, FALCON_SIGMA, tail_budget=0.01)
    ops = kc.kernel_operands(pre)
    y, _ = kc.klein_draw(ops, POINTS_IMHK_ROWS[0], seed=41)
    x = kc.from_kernel_layout(ops, y)
    del y
    limbs = s.ptc.points_operands(basis)
    cases["imhk_1024"] = points_case(s, limbs, basis, x)
    del x
    lat2 = ntru_lattice(B2_NTRU1024_RING, q=12289, seed=0,
                        cache_dir=os.path.join(REPO, "bench_cache"),
                        device=dev)
    x = torch.randint(-POINTS_IMHK_TOP, POINTS_IMHK_TOP + 1,
                      (POINTS_IMHK_ROWS[1], lat2.n), device=dev,
                      generator=gen).to(torch.float32)
    cases["imhk_2048"] = points_case(
        s, s.ptc.points_operands(lat2.basis), lat2.basis, x)
    del x, lat2
    torch.cuda.empty_cache()
    ok = all(v["bit_for_bit"] and v["limb_stats_ok"] for v in cases.values())
    # the limbs the cells' tiles take: IMHK's one, Peikert's and the
    # signer's two
    ok = ok and all(cases[k]["limb_stats"]["limbs_2"] == 0
                    for k in ("imhk_1024", "imhk_2048")) \
        and cases["peikert"]["limb_stats"]["limbs_2"] > 0 \
        and cases["sign"]["limb_stats"]["limbs_2"] > 0
    p = cases["peikert"]
    s.note("PTS", ms=p["ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
           library_ms=p["dgemm_ms"], shape=f"{p['shape'][0]} x "
           f"{p['shape'][1]} x {p['shape'][1]}, Peikert's ring view",
           cases={k: {kk: v[kk] for kk in ("ms", "dgemm_ms", "bound_ms")}
                  for k, v in cases.items()})
    return ok, cases


# ---------------------------------------------------------- kernel_vs_plain
def centre_err(pre, ops, y, c):
    """max_i |c_i - c_f64,i| / sigma_i of the kernel's own conditional
    centres c (n_pad, B) of its draw y (n_pad, B), both recentred, against
    float64 from the float64 precomputation."""
    n = ops.n
    shift = ops.shift[:n, None].double()
    x64 = y[:n].double() + shift
    c64 = pre.cs[:, None] - pre.U @ x64 + x64
    return float(((c[:n].double() + shift - c64).abs()
                  / pre.sigmas[:, None]).max())


def check_b6(s: Smoke):
    """B6 at the suite's klein-row operands on NTRU-512 (sigma 1.3
    max ||b*_i||, tail budget 0.01), CHECK_CHAINS chains x 3 rounds: one
    code path with B1 (round 0, and a one-round ring, bit for bit), every
    round against the plain version on the caller's uniforms and on Philox
    (round r at step + r), rounds pairwise different; its own centres (its
    debug instantiation, drawing the same rounds bit for bit) against
    float64."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    kc, B, R = s.kc, CHECK_CHAINS, B6_CHECK_ROUNDS
    pre = klein_precompute(s.lat, KLEIN_ROW_SIGMA_OVER_MAX_GS * float(
        s.lat.gs_norms.max()), tail_budget=0.01)
    ops = kc.kernel_operands(pre)
    n, n_pad = ops.n, ops.n_pad
    u = torch.rand(R * n_pad, B, device=s.dev, generator=s.gen)
    out, outp = [], []
    ms = cuda_ms(lambda: out.extend(kc.klein_ring(ops, B, R, uniforms=u)))
    plain_ms = cuda_ms(lambda: outp.extend(kc.klein_ring_plain(
        ops, B, R, uniforms=u)))
    y1, l1 = kc.klein_draw(ops, B, uniforms=u[:n_pad])
    round0 = torch.equal(out[0][:n_pad], y1) and torch.equal(out[1][0], l1)
    r1, lr1 = kc.klein_ring(ops, B, 1, seed=61, step=5)
    y1, l1 = kc.klein_draw(ops, B, seed=61, step=5)
    one_round = torch.equal(r1, y1) and torch.equal(lr1[0], l1)

    def rounds(ring, ringp, lw, lwp):
        return [compare_draws(ring[r * n_pad:(r + 1) * n_pad],
                              ringp[r * n_pad:(r + 1) * n_pad], lw[r],
                              lwp[r], n) for r in range(R)]

    host = rounds(out[0], outp[0], out[1], outp[1])
    rq, lq = kc.klein_ring(ops, B, R, seed=62, step=3)
    rqp, lqp = kc.klein_ring_plain(ops, B, R, seed=62, step=3)
    philox = rounds(rq, rqp, lq, lqp)
    distinct = all(not torch.equal(rq[a * n_pad:(a + 1) * n_pad],
                                   rq[b * n_pad:(b + 1) * n_pad])
                   for a in range(R) for b in range(a + 1, R))
    cq, rqd, lqd = kc.klein_centres(ops, B, R, seed=62, step=3)
    debug_equal = torch.equal(rqd, rq) and torch.equal(lqd, lq)
    centre = max(centre_err(pre, ops, rq[r * n_pad:(r + 1) * n_pad],
                            cq[r * n_pad:(r + 1) * n_pad]) for r in range(R))
    del cq, rqd
    max_abs_y = s.max_y("klein_ring")
    ok = (round0 and one_round and distinct and debug_equal
          and centre < MAX_CENTRE_ERR
          and all(draws_ok(r) for r in host + philox))
    s.note("B6", max_abs_err=max(r["max_abs_lw_err"] for r in host + philox),
           coeffs_differing=max(r["coeffs_differing"] for r in host + philox),
           max_centre_err_over_sigma=centre, plain_ms=plain_ms, check_ms=ms,
           check_shape=f"{B} chains x {R} rounds, window {ops.window}")
    return ok, {"round0_equals_b1": round0, "one_round_equals_b1": one_round,
                "rounds_distinct": distinct, "host": host, "philox": philox,
                "debug_draws_equal": debug_equal,
                "max_kernel_centre_err_over_sigma": centre,
                "max_abs_y": max_abs_y, "rounds": R, "window": ops.window}


def check_qary(s: Smoke):
    """B1, B6 and B2 at the suite's klein and imhk operands below 256, B5
    at its Peikert operands there, QARY_CHAINS chains: each against its
    plain version on the caller's uniforms (and B1, B5 on Philox too),
    with the largest |y| each kernel drew (hazard C8; read from a guard of
    the check's own) and the launches that took the WIDE instantiations
    (the launch record's `wide_launches`), which must not be 0 where
    `wide_y` predicts draws past 256."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import benchmark
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        PeikertSampler,
        klein_precompute,
    )
    kc, pc, dev, gen, B = s.kc, s.pc, s.dev, s.gen, QARY_CHAINS
    out, ok = {}, True
    for n in QARY_DIMS:
        lat = benchmark.reduced_qary_lattice(n, QARY_SEED, dev)
        max_gs = float(lat.gs_norms.max())
        pre = klein_precompute(lat, 1.5 * max_gs, tail_budget=0.01)
        ops = kc.kernel_operands(pre)
        n_pad, R = ops.n_pad, QARY_ROUNDS
        guard = s.rec.ExactGuard(dev)
        wide_before = s.wide_launches()
        u1 = torch.rand(n_pad, B, device=dev, generator=gen)
        y, lw = kc.klein_draw(ops, B, uniforms=u1, guard=guard)
        yp, lwp = kc.klein_draw_plain(ops, B, uniforms=u1)
        b1 = compare_draws(y, yp, lw, lwp, n)
        yq, lq = kc.klein_draw(ops, B, seed=81, guard=guard)
        yqp, lqp = kc.klein_draw_plain(ops, B, seed=81)
        b1_philox = compare_draws(yq, yqp, lq, lqp, n)
        u6 = torch.rand(R * n_pad, B, device=dev, generator=gen)
        ring, lws = kc.klein_ring(ops, B, R, uniforms=u6, guard=guard)
        ringp, lwsp = kc.klein_ring_plain(ops, B, R, uniforms=u6)
        b6 = [compare_draws(ring[r * n_pad:(r + 1) * n_pad],
                            ringp[r * n_pad:(r + 1) * n_pad], lws[r],
                            lwsp[r], n) for r in range(R)]
        u2 = torch.rand(QARY_STEPS * (n_pad + kc.ACCEPT_ROWS), B,
                        device=dev, generator=gen)
        x, lx, ax = yp.clone(), lwp.clone(), torch.zeros_like(lwp)
        xp, lxp, axp = yp.clone(), lwp.clone(), torch.zeros_like(lwp)
        kc.imhk_fused(ops, x, lx, ax, QARY_STEPS, uniforms=u2, guard=guard)
        kc.imhk_fused_plain(ops, xp, lxp, axp, QARY_STEPS, uniforms=u2)
        b2 = compare_steps(x, xp, lx, lxp, ax, axp, n, QARY_STEPS)
        rows = guard.read()
        counted = sum(b for b, _ in rows.values())
        wide = kc.wide_y(ops)
        wide_launches = s.wide_launches() - wide_before
        del u1, u6, u2, ring, ringp, x, xp
        sp = PeikertSampler(lat, 3.0 * float(np.linalg.norm(
            lat.basis.cpu().numpy(), 2)), device=dev)
        ops_p = sp.operands
        z = torch.randn(2 * ops_p.n_pad, B, device=dev, generator=gen)
        u5 = torch.rand(2 * ops_p.n_pad, B, device=dev, generator=gen)
        b5 = compare_rings(pc.peikert_rounds(ops_p, B, 2, uniforms=u5,
                                             normals=z),
                           pc.peikert_rounds_plain(ops_p, B, 2, uniforms=u5,
                                                   normals=z))
        b5_philox = compare_rings(pc.peikert_rounds(ops_p, B, 2, seed=82),
                                  pc.peikert_rounds_plain(ops_p, B, 2,
                                                          seed=82))
        n_ok = (draws_ok(b1) and draws_ok(b1_philox)
                and all(draws_ok(r) for r in b6)
                and draws_ok(b2) and b2["accept_differing"] <= MAX_ACCEPT_SHARE
                and b2["accept_differing_agreeing"] == 0 and counted == 0
                and (wide_launches > 0 or not wide)
                and all(r["coeffs_differing"] <= MAX_COEFF_SHARE
                        and r["ties_off_by_one"] for r in (b5, b5_philox)))
        ok = ok and n_ok
        for key, res in (("B1", b1), ("B2", b2), ("B6", b6[0]), ("B5", b5)):
            s.note(key, **{f"qary{n}_coeffs_differing":
                           res["coeffs_differing"]})
        s.note("B2", **{f"qary{n}_wide_launches": wide_launches})
        # each kernel at the suite row's shapes (65,536 chains; B1 the
        # imhk row's start, B2 its 16 steps, B6 the klein row's 8 rounds,
        # B5 the Peikert row's one round), by CUDA events
        Bs, times = SUITE_CHAINS, {}
        times["B1"] = cuda_ms(lambda: kc.klein_draw(ops, Bs, seed=84),
                              reps=3)
        times["B6"] = cuda_ms(lambda: kc.klein_ring(ops, Bs, 8, seed=84),
                              reps=3)
        x0, l0 = kc.klein_draw(ops, Bs, seed=84)
        times["B2"] = cuda_ms(lambda: kc.imhk_fused(
            ops, x0, l0, torch.zeros_like(l0), 16, seed=84, step=1), reps=3)
        times["B5"] = cuda_ms(lambda: pc.peikert_rounds(ops_p, Bs, 1,
                                                        seed=84), reps=3)
        plain = {"B1": cuda_ms(lambda: kc.klein_draw_plain(ops, Bs,
                                                           seed=84)),
                 "B6": cuda_ms(lambda: kc.klein_ring_plain(ops, Bs, 8,
                                                           seed=84))}
        del x0, l0
        for key, ms in times.items():
            s.note(key, **{f"qary{n}_ms": ms})
        for key, ms in plain.items():
            s.note(key, **{f"qary{n}_plain_ms": ms})
        out[f"n{n}"] = {
            "ok": n_ok, "n_pad": n_pad, "window": ops.window,
            "wide": wide, "wide_launches": wide_launches,
            "sigma": pre.sigma.item(),
            "max_abs_y": {"b2": rows["imhk_fused"][1],
                          "b1": rows["klein_draw"][1],
                          "b6": rows["klein_ring"][1]},
            "max_abs_coeff_b5": float(pc.ring_coeffs(ops_p, pc.peikert_rounds(
                ops_p, B, 1, seed=83)).abs().max()),
            "counted_beyond_256": counted, "b1": b1, "b1_philox": b1_philox,
            "b6": b6, "b2": dict(b2, steps=QARY_STEPS),
            "b5": dict(b5, window=ops_p.window), "b5_philox": b5_philox,
            "suite_shape_ms": times,
            "suite_shape_plain_ms": plain}
    return ok, out


def blocked_vs_plain(s: Smoke, pre, B, steps, philox, hard=False):
    """B1 on the blocked route's own operands (`blocked_operands(pre)`), B
    chains, then `steps` B2 steps from the plain draw (as the drivers step
    from their draw), each against its plain version on the caller's
    uniforms and on Philox (`philox`: the seed and the first chain).
    check_qary's gates, B2 at a hard sigma held as in the 2D hard regime
    (`hard_decisions_ok`), with the largest |y| each kernel drew and the
    count beyond 256 (hazard C8) from a guard of the check's own.
    Returns (ok, result)."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
        blocked_operands,
    )
    kc, dev, gen = s.kc, s.dev, s.gen
    ops = blocked_operands(pre)
    n, n_pad = ops.n, ops.n_pad
    guard = s.rec.ExactGuard(dev)
    u1 = torch.rand(n_pad, B, device=dev, generator=gen)
    y, lw = kc.klein_draw(ops, B, uniforms=u1, guard=guard)
    yp, lwp = kc.klein_draw_plain(ops, B, uniforms=u1)
    res = {"b1": compare_draws(y, yp, lw, lwp, n)}
    y, lw = kc.klein_draw(ops, B, guard=guard, **philox)
    yp, lwp = kc.klein_draw_plain(ops, B, **philox)
    res["b1_philox"] = compare_draws(y, yp, lw, lwp, n)
    del u1, y, lw
    if steps:
        u2 = torch.rand(steps * (n_pad + kc.ACCEPT_ROWS), B, device=dev,
                        generator=gen)
        for key, kw in (("b2", {"uniforms": u2}),
                        ("b2_philox", dict(philox, step=1))):
            x, lx, ax = yp.clone(), lwp.clone(), torch.zeros_like(lwp)
            xp, lxp, axp = yp.clone(), lwp.clone(), torch.zeros_like(lwp)
            kc.imhk_fused(ops, x, lx, ax, steps, guard=guard, **kw)
            kc.imhk_fused_plain(ops, xp, lxp, axp, steps, **kw)
            res[key] = dict(compare_steps(x, xp, lx, lxp, ax, axp, n,
                                          steps), steps=steps)
        del u2, x, xp
    rows = guard.read()
    counted = sum(b for b, _ in rows.values())
    ok = (all(draws_ok(r) for r in res.values()) and counted == 0
          and all(hard_decisions_ok(r, B) if hard else
                  r["accept_differing"] <= MAX_ACCEPT_SHARE
                  and r["accept_differing_agreeing"] == 0
                  for k, r in res.items() if k.startswith("b2")))
    return ok, dict(res, ok=ok, dim=n, chains=B, n_pad=n_pad,
                    sigma=pre.sigma.item(), window=ops.window,
                    wide=kc.wide_y(ops),
                    route=kc.klein_route(n_pad, ops.window,
                                         wide=kc.wide_y(ops)),
                    max_abs_y={"b1": rows["klein_draw"][1],
                               "b2": rows["imhk_fused"][1]},
                    counted_beyond_256=counted)


def check_cli_shapes(s: Smoke):
    """B1 and B2 at the cli phase's shapes that the checks above do not
    reach (`blocked_vs_plain`, CHECK_CHAINS chains): B1 on Z^2048 at 2 eta
    (the asymptotics' largest draw: W 56 on B1's run-time window loop, one
    block an SM), B1 on NTRU-512 at max||b*_i|| (the adaptation's start),
    and B1 then QARY_STEPS B2 steps on every crypto row that samples
    (identity and checkerboard 64, the BKZ-20 q-ary 64, NTRU-64/256/512 at
    the suite's sigma)."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import cryptographic
    from lattice_gaussian_mcmc_tpu_torch.experiments.adaptation import (
        AdaptationConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
        CryptoConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        identity_lattice,
        ntru_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
        smoothing_parameter,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    dev = s.dev
    z = identity_lattice(2048, device=dev)
    ad = AdaptationConfig()
    ntru = ntru_lattice(ad.ntru_n, q=ad.ntru_q, seed=ad.seed,
                        cache_dir=os.path.join(REPO, ad.cache_dir),
                        device=dev)
    shapes = [("z2048_asymptotics", z, 2.0 * float(smoothing_parameter(z)),
               0),
              ("ntru512_adaptation_start", ntru,
               ad.sigma_factor * float(torch.max(ntru.gs_norms)), 0)]
    cfg = CryptoConfig(qary_dims=(64,),
                       cache_dir=os.path.join(REPO, CryptoConfig.cache_dir))
    for name, lat in cryptographic.build_lattice_suite(cfg, dev).items():
        shapes.append((f"crypto_{name}", lat, cryptographic.suite_sigma(lat),
                       QARY_STEPS))
    out, ok = {}, True
    for name, lat, sigma, steps in shapes:
        pre = klein_precompute(lat, sigma)
        if pre.clamped:                      # the driver skips the row
            out[name] = {"window_clamped": True}
            continue
        n_ok, out[name] = blocked_vs_plain(s, pre, CHECK_CHAINS, steps,
                                           {"seed": 91})
        ok = ok and n_ok
        del pre
    return ok, out


def check_mesh_shapes(s: Smoke):
    """B1, B2 and B5 at the mesh phase's shapes that the checks above do
    not reach, on the paths' own operands: B1 at every klein_scaling
    dimension (its LLL-reduced random basis at 1.5 max||b*_i||,
    KLEIN_SCALING_SAMPLES chains); B1, the kernel rows' KERNEL_STEPS B2
    steps and PEIKERT_ROUNDS B5 rounds on the CLI card rows' n = 8
    unit-triangular basis; the same on the dry run's n = 8 integer basis
    at its hard sigma, where B2 rejects and Philox reads rank 1's chains.
    B1/B2 by `blocked_vs_plain` (CHECK_CHAINS chains at n = 8); B5 against
    its plain version on the caller's uniforms and normals and on Philox,
    check_qary's gates."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import mesh_scaling
    from lattice_gaussian_mcmc_tpu_torch.experiments.klein_scaling import (
        stage_precompute,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel import dryrun
    pc, dev, gen = s.pc, s.dev, s.gen
    card_pre, card_ops = mesh_scaling.kernel_row_problem(dev)
    hard_pre, hard_ops = dryrun.hard_problem(dev)
    # (name, Klein precomputation, chains, B2 steps, Peikert operands,
    #  B5 rounds, Philox's first chain, B2 at a hard sigma)
    shapes = [(f"klein_scaling_{n}", stage_precompute(n, KLEIN_SCALING_SEED,
                                                      device=dev)[0],
               KLEIN_SCALING_SAMPLES, 0, None, 0, 0, False)
              for n in KLEIN_SCALING_DIMS]
    shapes += [("cli_card_rows", card_pre, CHECK_CHAINS,
                mesh_scaling.KERNEL_STEPS, card_ops,
                mesh_scaling.PEIKERT_ROUNDS, 0, False),
               ("dryrun_hard", hard_pre, CHECK_CHAINS, dryrun.KERNEL_STEPS,
                hard_ops, dryrun.PEIKERT_ROUNDS,
                dryrun.KERNEL_CHAINS_PER_RANK, True)]
    out, ok = {}, True
    for name, pre, B, steps, ops_p, rounds, offset, hard in shapes:
        philox = {"seed": 92, "chain_offset": offset}
        n_ok, res = blocked_vs_plain(s, pre, B, steps, philox, hard)
        if rounds:
            z = torch.randn(rounds * ops_p.n_pad, B, device=dev, generator=gen)
            u5 = torch.rand(rounds * ops_p.n_pad, B, device=dev, generator=gen)
            res["b5"] = compare_rings(
                pc.peikert_rounds(ops_p, B, rounds, uniforms=u5, normals=z),
                pc.peikert_rounds_plain(ops_p, B, rounds, uniforms=u5,
                                        normals=z))
            res["b5_philox"] = compare_rings(
                pc.peikert_rounds(ops_p, B, rounds, **philox),
                pc.peikert_rounds_plain(ops_p, B, rounds, **philox))
            n_ok = n_ok and all(r["coeffs_differing"] <= MAX_COEFF_SHARE
                                and r["ties_off_by_one"]
                                for r in (res["b5"], res["b5_philox"]))
            res["b5_shape"] = {"rounds": rounds, "n_pad": ops_p.n_pad,
                               "window": ops_p.window}
            del z, u5
        ok = ok and n_ok
        out[name] = dict(res, ok=n_ok, philox_chain_offset=offset)
    return ok, out


def check_fp32_route(s: Smoke):
    """B1, B6 and B7 above the tensor-core sweep's reach, where the
    wrappers take klein.cu's FP32 sweep: an upper-triangular basis of
    dimension FP32_ROUTE_N (its own R, Q = I), FP32_ROUTE_CHAINS chains;
    B1 against its plain version on the caller's uniforms, B6 (2 rounds) on
    Philox, round 0 = B1 bit for bit; B7 on FP32_ROUTE_TARGETS targets
    B x* + w against its plain version and the float64 nearest plane; all
    counted as FP32 launches."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_numpy
    from lattice_gaussian_mcmc_tpu_torch.ops import linalg
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    kc, B, R, N = s.kc, FP32_ROUTE_CHAINS, FP32_ROUTE_ROUNDS, FP32_ROUTE_N
    rng = np.random.default_rng(35)
    basis = (np.triu(rng.uniform(-0.05, 0.05, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(N), "R": basis,
                              "gs_norms": np.diag(basis)}, device=s.dev)
    ops = kc.kernel_operands(klein_precompute(lat, FP32_ROUTE_SIGMA,
                                              tail_budget=0.01))
    n_pad = ops.n_pad

    def counts():
        c = s.counts()
        return [c[k] for k in ("klein_draw", "klein_ring", "klein_draw_fp32",
                               "klein_ring_fp32")]

    before = counts()
    u = torch.rand(n_pad, B, device=s.dev, generator=s.gen)
    out, outp = [], []
    ms = cuda_ms(lambda: out.extend(kc.klein_draw(ops, B, uniforms=u)))
    plain_ms = cuda_ms(lambda: outp.extend(kc.klein_draw_plain(
        ops, B, uniforms=u)))
    host = compare_draws(out[0], outp[0], out[1], outp[1], N)
    ring, lws = kc.klein_ring(ops, B, R, seed=63, step=2)
    ringp, lwsp = kc.klein_ring_plain(ops, B, R, seed=63, step=2)
    philox = [compare_draws(ring[r * n_pad:(r + 1) * n_pad],
                            ringp[r * n_pad:(r + 1) * n_pad], lws[r],
                            lwsp[r], N) for r in range(R)]
    y0, l0 = kc.klein_draw(ops, B, seed=63, step=2)
    round0 = torch.equal(ring[:n_pad], y0) and torch.equal(lws[0], l0)
    distinct = not torch.equal(ring[:n_pad], ring[n_pad:2 * n_pad])
    d = [a - b for a, b in zip(counts(), before)]
    routed = kc.klein_route(n_pad) == "klein" and d == [0, 0, 2, 1]
    # B7 on the same lattice
    T = FP32_ROUTE_TARGETS
    xs = torch.randint(-2, 3, (T, N), device=s.dev, generator=s.gen).double()
    t = xs @ lat.basis.T + FP32_ROUTE_NOISE * torch.randn(
        T, N, device=s.dev, generator=s.gen, dtype=torch.float64)
    ops7 = kc.babai_operands(lat.Q, lat.R)
    ct, k = kc.babai_centres(ops7, t)
    b7_before = s.counts()
    out7 = []
    ms7 = cuda_ms(lambda: out7.append(kc.babai_decode(ops7, ct)))
    d7 = [s.counts()[k] - b7_before[k]
          for k in ("babai_decode", "babai_decode_fp32")]
    plain7 = []
    plain_ms7 = cuda_ms(lambda: plain7.append(kc.babai_decode_plain(ops7,
                                                                    ct)))
    zeros = torch.zeros(T, device=s.dev)
    b7 = compare_draws(out7[0], plain7[0], zeros, zeros, N)
    del b7["max_abs_lw_err"]
    X7 = out7[0][:N].T.double() + k
    n_diff, tie_dist = babai_ties(lat, t, X7,
                                  linalg.babai_nearest_plane(lat.Q, lat.R, t))
    b7.update({"targets": T, "launches_tc_fp32": d7,
               "vs_float64_differing": n_diff, "max_tie_distance": tie_dist,
               "exact_x_star": int((X7 == xs).all(dim=1).sum()),
               "ms": ms7, "plain_ms": plain_ms7})
    b7_ok = (d7 == [0, 1] and b7["coeffs_differing"] <= MAX_COEFF_SHARE
             and b7["chains_differing"] <= MAX_CHAIN_SHARE
             and b7["ties_off_by_one"]
             and (n_diff == 0 or tie_dist <= BABAI_TIE_TOL))
    del out7, plain7, ct
    s.note("B7", fp32_route={
        "source": "lattice_gaussian_mcmc_tpu_torch/csrc/klein.cu",
        "above_n_pad": kc.KLEIN_TC_MAX_N_PAD,
        "check_shape": f"{T} targets, dim {N}",
        "coeffs_differing": b7["coeffs_differing"],
        "vs_float64_differing": n_diff, "check_ms": ms7,
        "plain_ms": plain_ms7})
    ok = (routed and round0 and distinct and b7_ok
          and all(draws_ok(r) for r in [host] + philox))
    res = {"dim": N, "n_pad": n_pad, "window": ops.window, "chains": B,
           "route": kc.klein_route(n_pad), "launches_tc_b1_b6_fp32_b1_b6": d,
           "host": host, "philox": philox, "round0_equals_b1": round0,
           "rounds_distinct": distinct, "ms": ms, "plain_ms": plain_ms,
           "b7": b7}
    s.note("B1", fp32_route={
        "source": "lattice_gaussian_mcmc_tpu_torch/csrc/klein.cu",
        "above_n_pad": kc.KLEIN_TC_MAX_N_PAD,
        "check_shape": f"{B} chains, dim {N}, window {ops.window}",
        "max_abs_err": max(r["max_abs_lw_err"] for r in [host] + philox),
        "coeffs_differing": max(r["coeffs_differing"]
                                for r in [host] + philox),
        "check_ms": ms, "plain_ms": plain_ms})
    return ok, res


def check_b5_wide(s: Smoke):
    """B5 at NTRU-1024 (dimension 2048: n_pad above 1,792, so 16 chains a
    block), bench.py's Peikert row at BENCH_N = 1024 (sigma 1.05 r s1(B),
    the window of suggest_peikert_window), CHECK_CHAINS chains x 2 rounds:
    against its plain version on the caller's normals and on Philox, its
    own centres against float64, and E||Bx||^2 / (dim sigma^2) of its
    Philox draws."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
        smoothing_parameter_zn,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import PeikertSampler
    pc, B, nr = s.pc, CHECK_CHAINS, B5_CHECK_ROUNDS
    lat = ntru_lattice(PEIKERT_WIDE_RING, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device=s.dev)
    s1 = float(torch.linalg.matrix_norm(lat.basis, ord=2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    sigma = PEIKERT_SIGMA_OVER_RS1 * r * s1
    sp = PeikertSampler(lat, sigma)
    ops = sp.operands
    n, n_pad = ops.n, ops.n_pad
    chains_a_block = pc.peikert_block_chains(n_pad)
    z = torch.randn(nr * n_pad, B, device=s.dev, generator=s.gen)
    u = torch.rand(nr * n_pad, B, device=s.dev, generator=s.gen)
    pc.peikert_rounds(ops, B, nr, uniforms=u, normals=z)      # warm-up
    out, outp = [], []
    ms = cuda_ms(lambda: out.append(pc.peikert_rounds(
        ops, B, nr, uniforms=u, normals=z)))
    plain_ms = cuda_ms(lambda: outp.append(pc.peikert_rounds_plain(
        ops, B, nr, uniforms=u, normals=z)))
    host = compare_rings(out[0], outp[0])
    ring = pc.peikert_rounds(ops, B, nr, seed=43)
    philox = compare_rings(ring, pc.peikert_rounds_plain(ops, B, nr,
                                                         seed=43))
    c5, _ = pc.peikert_centres(ops, B, uniforms=u[:n_pad],
                               normals=z[:n_pad])
    c64 = (sp.pre.cprime.double()[:, None]
           - sp.pre.L2.double() @ z[:n].double())
    centre = float((c5[:n].double() - c64).abs().max()) / r
    del c5, c64, z, u, out, outp
    X = pc.ring_coeffs(ops, ring).reshape(-1, n).double()
    norm_ratio = float(((X @ lat.basis.T) ** 2).sum(1).mean()
                       / (n * sigma ** 2))
    del X, ring
    ok = (chains_a_block == 16 and centre <= MAX_PEIKERT_CENTRE_ERR
          and abs(norm_ratio - 1) < MAX_NORM_GAP
          and all(c["coeffs_differing"] <= MAX_COEFF_SHARE
                  and c["ties_off_by_one"] for c in (host, philox)))
    s.note("B5", wide={"check_shape": f"{B} chains x {nr} rounds, dim {n}, "
                                      f"window {ops.window}",
                       "chains_a_block": chains_a_block, "check_ms": ms,
                       "plain_ms": plain_ms,
                       "max_abs_err": max(host["max_abs_err"],
                                          philox["max_abs_err"]),
                       "max_centre_err_over_r": centre})
    return ok, {"dim": n, "n_pad": n_pad, "window": ops.window,
                "sigma": sigma, "chains": B, "rounds": nr,
                "chains_a_block": chains_a_block, "host": host,
                "philox": philox, "max_kernel_centre_err_over_r": centre,
                "norm2_over_dim_sigma2": norm_ratio, "ms": ms,
                "plain_ms": plain_ms}


def check_b2_ntru1024(s: Smoke):
    """B2 and B3 at NTRU-1024 (B2_NTRU1024_RING, FALCON1024_SIGMA: n_pad 2048,
    window 24), B2_NTRU1024_CHAINS chains: B2 against its plain version for 2
    steps on the caller's uniforms and on Philox, under the gates of the
    NTRU-512 check, and B3 against B2 bit for bit (final state, lw, counts
    and every ring entry), as at the hard-regime operands."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    kc, dev, gen, B = s.kc, s.dev, s.gen, B2_NTRU1024_CHAINS
    lat = ntru_lattice(B2_NTRU1024_RING, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device=dev)
    ops = kc.kernel_operands(klein_precompute(lat, FALCON1024_SIGMA,
                                              tail_budget=0.01))
    n, n_pad = ops.n, ops.n_pad
    if (n_pad, ops.window) != (2048, 24):
        fail("kernel_vs_plain", f"expected n_pad 2048 window 24 at "
                                f"NTRU-1024, got {n_pad} {ops.window}")
    u1 = torch.rand(n_pad, B, device=dev, generator=gen)
    y, lw = kc.klein_draw(ops, B, uniforms=u1)
    del u1
    host = fused_vs_plain(ops, y, lw, 2, gen)
    x, lx, ax = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lxp, axp = y.clone(), lw.clone(), torch.zeros_like(lw)
    kc.imhk_fused(ops, x, lx, ax, 2, seed=51, step=1)
    kc.imhk_fused_plain(ops, xp, lxp, axp, 2, seed=51, step=1)
    philox = compare_steps(x, xp, lx, lxp, ax, axp, n, 2)
    del x, xp
    x3, l3, a3 = y.clone(), lw.clone(), torch.zeros_like(lw)
    x3, l3, a3, tx, tlw = kc.imhk_trajectory(
        ops, x3, l3, a3, B3_CHECK_KEEP, B3_CHECK_THIN, seed=52, step=1,
        coeffs=True)
    x2, l2, a2 = y.clone(), lw.clone(), torch.zeros_like(lw)
    ring_equal = True
    for k in range(B3_CHECK_KEEP):
        kc.imhk_fused(ops, x2, l2, a2, B3_CHECK_THIN, seed=52,
                      step=1 + k * B3_CHECK_THIN)
        ring_equal &= (torch.equal(tlw[k], l2) and torch.equal(
            tx[k * n_pad:(k + 1) * n_pad], x2))
    b3_vs_b2 = {"ring_equal": ring_equal,
                "final_equal": (torch.equal(x3, x2) and torch.equal(l3, l2)
                                and torch.equal(a3, a2)),
                "rejections": int(B3_CHECK_KEEP * B3_CHECK_THIN * B
                                  - float(a3.sum()))}
    del y, x2, x3, tx
    ok = (all(draws_ok(r) and r["accept_differing"] <= MAX_ACCEPT_SHARE
              and r["accept_differing_agreeing"] == 0
              for r in (host, philox))
          and ring_equal and b3_vs_b2["final_equal"])
    s.note("B2", ntru1024_coeffs_differing=max(host["coeffs_differing"],
                                               philox["coeffs_differing"]),
           ntru1024_max_abs_lw_err=max(host["max_abs_lw_err"],
                                       philox["max_abs_lw_err"]))
    return ok, {"dim": n, "n_pad": n_pad, "window": ops.window,
                "sigma": FALCON1024_SIGMA, "chains": B, "steps": 2,
                "resident_chains":
                    s.rec.read()["imhk_fused"]["resident_chains"],
                "host": host, "philox": philox,
                "b3_vs_b2": dict(b3_vs_b2, keep=B3_CHECK_KEEP,
                                 thin=B3_CHECK_THIN)}


def reach_basis(rng, n=REACH_N):
    """(basis, x* sampler) of B7's reach check: basis = I + N with N
    integer, strictly upper-triangular and N^2 confined to rows 0-79.
    Rows 192-255 (S) have no entry off the diagonal; each of rows 80-191
    (M) one, a_m in the hundreds at a column of S; each of rows 0-79 (T)
    two entries +-1 at columns of M, so T couples to M across 64-row blocks
    and inside rows 64-127. For targets t = B x* + w, |w_i| = 1/4, Babai
    returns x*, k = rint(t) = B x*, and y = x* - k = -N x*: 0 on S,
    -a_m x*_s on M, small on T. x*_s is in {-1, 0, 1} on the first 16 rows
    of S (|y| <= 256), in 2 .. 60 on the next 16 (256 < |y| < 2^16) and
    odd in 1,001 .. 1,499 on the last 32, where an odd a_m in 601 .. 999
    makes |y| an odd number between 2^19 and 2^21 (its third bf16 part is
    not 0 but for a low part below 257); x* is in [-2, 2] elsewhere. The
    centres stay below 2^22 in magnitude, quarters exact in float32."""
    import numpy as np
    S = np.arange(192, n)
    small, mid = S[:16], S[16:32]
    Nm = np.zeros((n, n))
    for j, m in enumerate(range(80, 192)):
        col = S[j % len(S)]
        if col in small:
            a = rng.integers(100, 257)
        elif col in mid:
            a = rng.integers(100, 1000)
        else:
            a = 2 * rng.integers(300, 500) + 1
        Nm[m, col] = a * rng.choice([-1, 1])
    for t in range(80):
        cols = rng.choice(np.arange(max(t + 1, 80), 192), 2, replace=False)
        Nm[t, cols] = rng.choice([-1, 1], 2)
    basis = np.eye(n) + Nm

    def xstar(T):
        x = rng.integers(-2, 3, (T, n)).astype(np.float64)
        x[:, small] = rng.integers(-1, 2, (T, len(small)))
        x[:, mid] = (rng.integers(2, 61, (T, len(mid)))
                     * rng.choice([-1, 1], (T, len(mid))))
        big = S[32:]
        x[:, big] = ((2 * rng.integers(500, 750, (T, len(big))) + 1)
                     * rng.choice([-1, 1], (T, len(big))))
        return x

    return basis, xstar


def check_b7_reach(s: Smoke):
    """B7 where |y| passes 256 and 2^16 (`reach_basis`, REACH_TARGETS
    targets through Lattice.nearest_plane): equal to float64, to x* and to
    its plain version coefficient for coefficient, with the coefficients
    beyond 256 counted by the kernel; nothing raises."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_numpy
    from lattice_gaussian_mcmc_tpu_torch.ops import linalg
    kc, T = s.kc, REACH_TARGETS
    rng = np.random.default_rng(77)
    basis, xstar = reach_basis(rng)
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(REACH_N),
                              "R": basis, "gs_norms": np.ones(REACH_N)},
                             device=s.dev)
    xs = torch.from_numpy(xstar(T)).to(s.dev)
    w = torch.from_numpy(rng.choice([-0.25, 0.25], (T, REACH_N))).to(s.dev)
    t = xs @ lat.basis.T + w
    counts = s.counts()
    before = kc.babai_y_stats()
    X = lat.nearest_plane(t)
    after = kc.babai_y_stats()
    launches = tuple(s.counts()[k] - counts[k]
                     for k in ("babai_decode", "babai_decode_fp32"))
    Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t)
    ops = kc.babai_operands(lat.Q, lat.R)
    ct, k = kc.babai_centres(ops, t)
    y_plain = kc.babai_decode_plain(ops, ct)
    y64 = (xs - k).T                  # the recentred coefficients, exact
    y1 = y64.to(torch.bfloat16).double()
    r = y64 - y1
    y3 = r - r.to(torch.bfloat16).double()
    res = {"dim": REACH_N, "targets": T, "launches_tc_fp32": launches,
           "equal_float64": torch.equal(X, Xo),
           "equal_x_star": torch.equal(X, xs),
           "plain_equal_x_star": torch.equal(
               y_plain[:REACH_N].T.double() + k, xs),
           "kernel_beyond_256": after["beyond_256"] - before["beyond_256"],
           "kernel_max_abs_y": after["max_abs_y"],
           "float64_beyond_256": int((y64.abs() > 256).sum()),
           "float64_beyond_65536": int((y64.abs() > 65536).sum()),
           "float64_third_part_nonzero": int((y3 != 0).sum()),
           "float64_max_abs_y": float(y64.abs().max())}
    ok = (res["equal_float64"] and res["equal_x_star"]
          and res["plain_equal_x_star"] and launches == (1, 0)
          and res["kernel_beyond_256"] == res["float64_beyond_256"] > 0
          and res["kernel_max_abs_y"] == res["float64_max_abs_y"]
          and res["float64_beyond_65536"] > 0
          and res["float64_third_part_nonzero"] > 0)
    res["timing"] = time_b7_reach(s, kc, lat, ops, xstar, rng)
    return ok, res


def time_b7_reach(s: Smoke, kc, lat, ops, xstar, rng):
    """B7 on the reach basis's operands at REACH_TIMING_TARGETS targets by
    CUDA events: on t = B x* + w, where most 16-row tiles are flagged and
    take y's wide parts, and on t = w, where y = 0 and none is; with the
    coefficients beyond 256 that each run counted."""
    import torch
    T = REACH_TIMING_TARGETS
    w = torch.from_numpy(rng.choice([-0.25, 0.25], (T, REACH_N))).to(s.dev)
    xs = torch.from_numpy(xstar(T)).to(s.dev)
    out = {"targets": T}
    for name, t in (("wide", xs @ lat.basis.T + w), ("narrow", w)):
        ct, _ = kc.babai_centres(ops, t)
        before = kc.babai_y_stats()["beyond_256"]
        kc.babai_decode(ops, ct)
        out[f"{name}_beyond_256"] = (kc.babai_y_stats()["beyond_256"]
                                     - before)
        out[f"{name}_ms"] = cuda_ms(lambda: kc.babai_decode(ops, ct), reps=3)
    return out


def check_b7(s: Smoke):
    """B7 on NTRU-512 at CHECK_CHAINS targets B x* + w (noise 0.45
    min ||b*_i||): against its plain version, against the float64 nearest
    plane up to ties, and the count of targets that centres from a float32
    QR (hazard C7) decode otherwise; at noise 0.05 every target decoded to
    x*; in 2D at half-integer targets, equal to its plain version decision
    for decision (rintf, hazard C3); its reach in y (`check_b7_reach`)."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.ops import linalg
    kc, lat, T = s.kc, s.lat, CHECK_CHAINS
    ops = kc.babai_operands(lat.Q, lat.R)
    xs, t = decode_targets(lat, T, DECODE_RHOS[-1], s.gen)
    ct, k = kc.babai_centres(ops, t)
    kc.babai_decode(ops, ct)             # warm-up: U's fragments, the load
    out, outp = [], []
    ms = cuda_ms(lambda: out.append(kc.babai_decode(ops, ct)))
    plain_ms = cuda_ms(lambda: outp.append(kc.babai_decode_plain(ops, ct)))
    zeros = torch.zeros(T, device=s.dev)
    vs_plain = compare_draws(out[0], outp[0], zeros, zeros, lat.n)
    del vs_plain["max_abs_lw_err"]
    X = out[0][:lat.n].T.double() + k
    Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t)
    n_diff, tie_dist = babai_ties(lat, t, X, Xo)
    X32 = decode_from_centres(kc, ops, f32_qr_centres(lat, t))
    c7 = int((X32 != Xo).any(dim=1).sum())
    xs05, t05 = decode_targets(lat, T, DECODE_RHOS[0], s.gen)
    exact05 = int((lat.nearest_plane(t05) == xs05).all(dim=1).sum())
    reach_ok, reach = check_b7_reach(s)
    lat2 = lattice_from_basis([[1.0, 0.5], [0.0, 1.0]], device=s.dev)
    ops2 = kc.babai_operands(lat2.Q, lat2.R)
    h = torch.randint(-40, 41, (HARD_CHECK_CHAINS, 2), device=s.dev,
                      generator=s.gen).double() / 2
    ct2, _ = kc.babai_centres(ops2, h)
    half_ties = int((ct2[1].abs() == 0.5).sum())
    half_equal = torch.equal(kc.babai_decode(ops2, ct2),
                             kc.babai_decode_plain(ops2, ct2))
    ok = (vs_plain["coeffs_differing"] <= MAX_COEFF_SHARE
          and vs_plain["chains_differing"] <= MAX_CHAIN_SHARE
          and vs_plain["ties_off_by_one"]
          and (n_diff == 0 or tie_dist <= BABAI_TIE_TOL)
          and exact05 == T and half_equal and half_ties > 0 and reach_ok
          and reach["timing"]["wide_beyond_256"] > 0
          and reach["timing"]["narrow_beyond_256"] == 0)
    s.note("B7", max_abs_err=float((out[0] - outp[0]).abs().max()),
           coeffs_differing=vs_plain["coeffs_differing"],
           plain_ms=plain_ms, check_ms=ms,
           check_shape=f"{T} targets, dim {lat.n}",
           reach_max_abs_y=reach["kernel_max_abs_y"],
           reach_shape=f"{REACH_TIMING_TARGETS} targets, dim {REACH_N}",
           reach_wide_ms=reach["timing"]["wide_ms"],
           reach_narrow_ms=reach["timing"]["narrow_ms"])
    return ok, {"targets": T, "rho": DECODE_RHOS[-1], "vs_plain": vs_plain,
                "vs_float64_differing": n_diff,
                "max_tie_distance": tie_dist,
                "c7_f32_qr_differing_from_float64": c7,
                "exact_x_star": int((X == xs).all(dim=1).sum()),
                f"exact_x_star_rho{DECODE_RHOS[0]}": exact05,
                "half_integer_2d_equal": half_equal,
                "half_integer_2d_ties": half_ties, "reach": reach}


def check_b8(s: Smoke):
    """B8 at the suite's direct row (sigma 5, window of
    suggest_peikert_window(5, 1024)), CHECK_CHAINS x 1024 draws: equal to
    the plain version draw for draw on the caller's uniforms (the first
    ZN_BOUNDARY of them put exactly on CDF entries, where `<` and `<=`
    part) and on Philox; its first 16 draws are the four words of counters
    0-3, and the same in a run of another length."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
        suggest_peikert_window,
    )
    zc = s.zc
    W = suggest_peikert_window(ZN_SIGMA, s.lat.n)
    num = CHECK_CHAINS * s.lat.n
    _, cdf = zc.zn_cdf(ZN_SIGMA, 0.0, W, s.dev)
    ub = cdf[:-1] / cdf[-1]
    ub = ub[ub * cdf[-1] == cdf[:-1]]
    u = torch.rand(num, device=s.dev, generator=s.gen)
    if ub.numel():
        u[:ZN_BOUNDARY] = ub.repeat(-(-ZN_BOUNDARY // ub.numel()))[
            :ZN_BOUNDARY]
    out, outp = [], []
    ms = cuda_ms(lambda: out.append(zc.sample_zn_draws(
        num, ZN_SIGMA, 0.0, W, uniforms=u)))
    plain_ms = cuda_ms(lambda: outp.append(zc.sample_zn_draws_plain(
        num, ZN_SIGMA, 0.0, W, uniforms=u)))
    host = compare_rings(out[0], outp[0])
    host["boundary_differing"] = float(
        (out[0][:ZN_BOUNDARY] != outp[0][:ZN_BOUNDARY]).float().mean())
    philox = compare_rings(
        zc.sample_zn_draws(num, ZN_SIGMA, 0.0, W, seed=81, device=s.dev),
        zc.sample_zn_draws_plain(num, ZN_SIGMA, 0.0, W, seed=81,
                                 device=s.dev))
    # the stream: draws 4j .. 4j + 3 are the four words of counter j, and
    # a prefix of a longer run is the same draws
    from lattice_gaussian_mcmc_tpu_torch.utils import prng
    j = torch.arange(4, device=s.dev)
    words = prng.philox4x32(j, j * 0, j * 0, j * 0 + prng.TAG_ZN,
                            *prng.seed_key(81))
    u16 = prng.mantissa_uniform(torch.stack(words, dim=1).reshape(-1))
    head = zc.sample_zn_draws(16, ZN_SIGMA, 0.0, W, seed=81, device=s.dev)
    host["stream"] = {
        "words_of_counter": torch.equal(
            head, zc.sample_zn_draws(16, ZN_SIGMA, 0.0, W, uniforms=u16)),
        "prefix": torch.equal(head, zc.sample_zn_draws(
            num - 3, ZN_SIGMA, 0.0, W, seed=81, device=s.dev)[:16])}
    ok = (ub.numel() > 0 and all(host["stream"].values())
          and all(r["coeffs_differing"] == 0 for r in (host, philox)))
    s.note("B8", max_abs_err=max(host["max_abs_err"], philox["max_abs_err"]),
           coeffs_differing=max(host["coeffs_differing"],
                                philox["coeffs_differing"]),
           plain_ms=plain_ms, check_ms=ms,
           check_shape=f"{num} draws, window {W}")
    return ok, {"draws": num, "window": W, "boundary_uniforms": ZN_BOUNDARY,
                "boundary_entries": int(ub.numel()), "host": host,
                "philox": philox}


def sign_operands(s: Smoke):
    """Centred B1's operands at the signing width: NTRU-512 at FALCON-512's
    sigma and the signing tail budget (centre 0)."""
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    return s.kc.kernel_operands(klein_precompute(s.lat, SIGN_SIGMA,
                                                 tail_budget=SIGN_TAIL))


def check_b1_centred(s: Smoke):
    """Centred B1 at the signing width (n_pad 1024, window 40) on the
    signer's residual centres U r, r uniform on [-1/2, 1/2) in every
    coordinate and chain, CHECK_CHAINS - 3 chains (the last block part
    empty): against its plain version on the caller's uniforms and on
    Philox, and bit for bit against B1 with every centre equal to the
    operands' cs (on Philox, B1 on the midpoint uniforms of its counters,
    which centred B1 draws in-kernel)."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import sign_cuda
    kc, dev, gen = s.kc, s.dev, s.gen
    ops = sign_operands(s)
    n, n_pad, B = ops.n, ops.n_pad, CHECK_CHAINS - 3
    r = torch.rand(n, B, device=dev, dtype=torch.float64, generator=gen)
    cs = torch.zeros(n_pad, B, device=dev)
    cs[:n] = ops.U[:n, :n].double() @ (r - 0.5)
    u = torch.rand(n_pad, B, device=dev, generator=gen)
    res, plain_ms = {}, None
    for name, kw in (("host", {"uniforms": u}),
                     ("philox", {"seed": 2 ** 33 + 17, "step": 2})):
        y, lw = kc.klein_draw_centred(ops, cs, **kw)
        outp = []
        plain_ms = cuda_ms(lambda: outp.extend(
            kc.klein_draw_centred_plain(ops, cs, **kw)))
        res[name] = compare_draws(y, outp[0], lw, outp[1], n)
    same = ops.cs[:, None].expand(-1, B).contiguous()
    mid = sign_cuda.redraw_uniforms(23, torch.arange(B, device=dev), 1,
                                    n_pad)
    equal = {}
    for name, kw, kwb in (("host", {"uniforms": u}, {"uniforms": u}),
                          ("philox", {"seed": 23, "step": 1},
                           {"uniforms": mid})):
        y, lw = kc.klein_draw_centred(ops, same, **kw)
        yb, lwb = kc.klein_draw(ops, B, **kwb)
        equal[name] = torch.equal(y, yb) and torch.equal(lw, lwb)
    max_y = s.max_y("klein_draw_centred")
    ok = (ops.window == SIGN_WINDOW and all(map(draws_ok, res.values()))
          and all(equal.values()) and 0 < max_y <= kc.EXACT_Y)
    s.note("B1c", max_abs_err=max(v["max_abs_lw_err"] for v in res.values()),
           coeffs_differing=max(v["coeffs_differing"]
                                for v in res.values()),
           plain_ms=plain_ms, check_shape=f"{B} chains, window {ops.window}")
    return ok, dict(res, equal_centres_are_b1=equal, max_abs_y=max_y,
                    chains=B, window=ops.window)


def phase_kernel_vs_plain(s: Smoke):
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        IMHKSampler,
        PeikertSampler,
        SMKSampler,
        klein_precompute,
    )
    kc, sc, pc, dev, gen = s.kc, s.sc, s.pc, s.dev, s.gen
    pre = klein_precompute(s.lat, FALCON_SIGMA, tail_budget=0.01)
    ops = kc.kernel_operands(pre)
    n, n_pad, W = ops.n, ops.n_pad, ops.window
    if (n, W) != (1024, 16):
        fail("kernel_vs_plain", f"expected dim 1024 window 16, got {n} {W}")
    B = CHECK_CHAINS
    u1 = torch.rand(n_pad, B, device=dev, generator=gen)
    y, lw = kc.klein_draw(ops, B, uniforms=u1)
    yp, lwp = kc.klein_draw_plain(ops, B, uniforms=u1)
    torch.cuda.synchronize()
    b1 = compare_draws(y, yp, lw, lwp, n)
    b2 = fused_vs_plain(ops, y, lw, 2, gen)
    # conditional centres of B1's draws: float32 from the kernel's operands
    # (recentered frame) against float64 from the float64 precomputation.
    # These are the plain version's centres; the kernel's own are held to
    # them by the tie gates above (a TF32 or bf16 coupling would move them
    # by ~1e-3 of |c| and flip a large share of the draws).
    centre = centre_err(pre, ops, y, ops.cs[:, None] - ops.U @ y + y)
    # ... and the kernel's own: B2's debug instantiation writes the
    # conditional centres of one proposal (its three-pass bf16 coupling,
    # hazard C2) beside the proposal, held to float64 from that proposal
    xc, lc = y.clone(), lw.clone()
    ck, yk = kc.imhk_centres(ops, xc, lc, seed=13, step=1)
    centre_kernel = centre_err(pre, ops, yk, ck)
    # B1's own centres (its debug instantiation) against float64, and one
    # stream with B2: B1 at Philox step s draws B2's step-s proposal with
    # the same centres, bit for bit
    c1, y1c, l1c = kc.klein_centres(ops, B, seed=13, step=1)
    y1s, l1s = kc.klein_draw(ops, B, seed=13, step=1)
    b1_is_b2 = {"draw_equals_b2_proposal": torch.equal(y1s, yk),
                "debug_draw_equals_b1": (torch.equal(y1c, y1s)
                                         and torch.equal(l1c[0], l1s)),
                "centres_equal_b2s": torch.equal(c1, ck)}
    centre_b1 = centre_err(pre, ops, y1c, c1)
    del xc, lc, ck, yk, c1, y1c, y1s
    # B2 where it rejects: the 2D hard regime (~1% of proposals rejected),
    # the operands of the law phase below, caller's uniforms
    basis2 = [[1.0, 0.5], [0.0, 1.0]]
    lat2 = lattice_from_basis(basis2, device=dev)
    s2 = IMHKSampler(lat2, HARD_SIGMA, burn_in=12)
    ops2 = s2.operands
    u0 = torch.rand(ops2.n_pad, HARD_CHECK_CHAINS, device=dev, generator=gen)
    y2, lw2 = kc.klein_draw(ops2, HARD_CHECK_CHAINS, uniforms=u0)
    b2_hard = fused_vs_plain(ops2, y2, lw2, HARD_CHECK_STEPS, gen)
    b1_ok = (draws_ok(b1) and centre_b1 < MAX_CENTRE_ERR
             and all(b1_is_b2.values()))
    b2_ok = (draws_ok(b2) and centre < MAX_CENTRE_ERR
             and centre_kernel < MAX_CENTRE_ERR
             and b2["accept_differing"] <= MAX_ACCEPT_SHARE
             and b2["accept_differing_agreeing"] == 0
             and hard_decisions_ok(b2_hard, HARD_CHECK_CHAINS))
    del u1, y, yp, u0
    s.note("B1", max_abs_err=b1["max_abs_lw_err"],
           coeffs_differing=b1["coeffs_differing"],
           max_centre_err_over_sigma=centre_b1)
    s.note("B2", max_abs_err=max(b2["max_abs_lw_err"],
                                 b2_hard["max_abs_lw_err"]),
           coeffs_differing=max(b2["coeffs_differing"],
                                b2_hard["coeffs_differing"]),
           accept_differing=max(b2["accept_differing"],
                                b2_hard["accept_differing"]))

    # B3 at the hard-regime row's operands (window 8, ~20% rejections).
    # Against B2: one code path, so the ring cannot change the chain; the
    # final state, lw and counts are B2's bit for bit, and ring entry k is
    # B2's state after (k + 1) thin steps, exactly. Against its plain
    # version: compare_steps on the caller's uniforms, and each lw of the
    # ring where the ring's states agree (a state's lw is a function of the
    # state alone).
    _, ops_h = s.hard_operands()
    yh, lwh = kc.klein_draw(ops_h, B, seed=21)
    x3, l3, a3 = yh.clone(), lwh.clone(), torch.zeros_like(lwh)
    x3, l3, a3, tx, tlw = kc.imhk_trajectory(
        ops_h, x3, l3, a3, B3_CHECK_KEEP, B3_CHECK_THIN, seed=22, step=1,
        coeffs=True)
    x2, l2, a2 = yh.clone(), lwh.clone(), torch.zeros_like(lwh)
    ring_equal = True
    for k in range(B3_CHECK_KEEP):
        kc.imhk_fused(ops_h, x2, l2, a2, B3_CHECK_THIN, seed=22,
                      step=1 + k * B3_CHECK_THIN)
        ring_equal &= (torch.equal(tlw[k], l2) and torch.equal(
            tx[k * ops_h.n_pad:(k + 1) * ops_h.n_pad], x2))
    b3_vs_b2 = {"ring_equal": ring_equal,
                "final_equal": (torch.equal(x3, x2) and torch.equal(l3, l2)
                                and torch.equal(a3, a2)),
                "rejections": int(B3_CHECK_KEEP * B3_CHECK_THIN * B
                                  - float(a3.sum()))}
    del x2, tx
    nk = B3_CHECK_KEEP
    u3 = torch.rand(nk * (ops_h.n_pad + kc.ACCEPT_ROWS), B, device=dev,
                    generator=gen)
    x3, l3, a3 = yh.clone(), lwh.clone(), torch.zeros_like(lwh)
    xp, lp, ap = yh.clone(), lwh.clone(), torch.zeros_like(lwh)
    out, outp = [], []
    b3_ms = cuda_ms(lambda: out.extend(kc.imhk_trajectory(
        ops_h, x3, l3, a3, nk, 1, uniforms=u3, coeffs=True)))
    b3_plain_ms = cuda_ms(lambda: outp.extend(kc.imhk_trajectory_plain(
        ops_h, xp, lp, ap, nk, 1, uniforms=u3, coeffs=True)))
    b3 = compare_steps(x3, xp, l3, lp, a3, ap, n, nk)
    # no agreeing chain at some k (a badly wrong kernel) reads as inf
    ring_err, np_ = 0.0, ops_h.n_pad
    for k in range(nk):
        same = (out[3][k * np_:k * np_ + n]
                == outp[3][k * np_:k * np_ + n]).all(dim=0)
        d = (out[4][k, same] - outp[4][k, same]).abs()
        ring_err = max(ring_err,
                       float(d.max()) if d.numel() else math.inf)
    b3["max_abs_ring_lw_err"] = ring_err
    b3_ok = (ring_equal and b3_vs_b2["final_equal"]
             and b3_vs_b2["rejections"] > 0 and draws_ok(b3)
             and b3["accept_differing"] <= MAX_ACCEPT_SHARE
             and b3["rejections"] > 0
             and b3["max_abs_ring_lw_err"] <= MAX_LW_ERR)
    del yh, x3, xp, out, outp, u3
    s.note("B3", max_abs_err=b3["max_abs_ring_lw_err"],
           coeffs_differing=b3["coeffs_differing"],
           accept_differing=b3["accept_differing"],
           plain_ms=b3_plain_ms, check_ms=b3_ms,
           check_shape=f"{B} chains x {nk} steps, window {ops_h.window}")

    # B4 at the SMK row's operands (target sigma_row, proposal 0.45
    # sigma_row, window 8), from a B1 draw of the target
    ss = SMKSampler(s.lat, s.sigma_row,
                    proposal_sigma=SMK_PROPOSAL_OVER_SIGMA * s.sigma_row,
                    tail_budget=0.01)
    y4, _ = kc.klein_draw(ss.klein_operands, B, seed=31)
    # warm-up: the operands' fragments and the kernel's first load stay
    # outside the timed launch
    sc.smk_steps(ss.operands, y4.clone(), torch.zeros(B, device=dev), 1)
    b4, b4_ms, b4_plain_ms = smk_vs_plain(ss.operands, y4, B4_CHECK_STEPS,
                                          gen)
    # ... B4's own forward and reverse centres (its debug instantiation)
    # against float64 from the target's float64 U, over the proposal widths
    b4_centre = smk_centre_err(ss, y4)
    # ... and in the 2D hard regime, where it rejects, decision by decision
    s4 = SMKSampler(lat2, HARD_SIGMA, proposal_sigma=SMK_2D_PROPOSAL)
    y4h, _ = kc.klein_draw(s4.klein_operands, HARD_CHECK_CHAINS, seed=32)
    b4_hard, _, _ = smk_vs_plain(s4.operands, y4h, HARD_CHECK_STEPS, gen)
    b4_hard["max_abs_lw_err"] = b4_hard["max_abs_log_alpha_err"]
    b4_ok = (b4["coeffs_differing"] <= MAX_COEFF_SHARE
             and b4["chains_differing"] <= MAX_CHAIN_SHARE
             and b4["ties_off_by_one"] and b4["rejections"] > 0
             and b4["accept_differing"] <= MAX_ACCEPT_SHARE
             and b4["max_abs_log_alpha_err"] <= MAX_LW_ERR
             and b4_centre < MAX_CENTRE_ERR
             and hard_decisions_ok(b4_hard, HARD_CHECK_CHAINS))
    del y4, y4h
    s.note("B4", max_abs_err=max(b4["max_abs_log_alpha_err"],
                                 b4_hard["max_abs_log_alpha_err"]),
           max_centre_err_over_sigma_prop=b4_centre,
           coeffs_differing=max(b4["coeffs_differing"],
                                b4_hard["coeffs_differing"]),
           accept_differing=max(b4["accept_differing"],
                                b4_hard["accept_differing"]),
           plain_ms=b4_plain_ms, check_ms=b4_ms,
           check_shape=f"{B} chains x {B4_CHECK_STEPS} steps, window "
                       f"{ss.operands.window}")

    # B5 at the Peikert row's operands (window 24): bit for bit on the
    # caller's normals up to ties; with in-kernel Philox the normals come
    # from the card's logf/sqrtf/cosf/sinf and torch's, which need not
    # round alike, so that run is held by its tie share alone
    sigma_pk, r_pk, _ = s.peikert_sigma()
    sp5 = PeikertSampler(s.lat, sigma_pk)
    ops_p = sp5.operands
    nr = B5_CHECK_ROUNDS
    z = torch.randn(nr * ops_p.n_pad, B, device=dev, generator=gen)
    u5 = torch.rand(nr * ops_p.n_pad, B, device=dev, generator=gen)
    pc.peikert_rounds(ops_p, B, nr, uniforms=u5, normals=z)    # warm-up
    out, outp = [], []
    b5_ms = cuda_ms(lambda: out.append(pc.peikert_rounds(
        ops_p, B, nr, uniforms=u5, normals=z)))
    b5_plain_ms = cuda_ms(lambda: outp.append(pc.peikert_rounds_plain(
        ops_p, B, nr, uniforms=u5, normals=z)))
    b5 = compare_rings(out[0], outp[0])
    b5_philox = compare_rings(pc.peikert_rounds(ops_p, B, nr, seed=41),
                              pc.peikert_rounds_plain(ops_p, B, nr, seed=41))
    # ... and B5's own centres (its debug instantiation, round 0 on the
    # caller's normals) against float64 from the float64 precomputation
    n5, np5 = ops_p.n, ops_p.n_pad
    c5, _ = pc.peikert_centres(ops_p, B, uniforms=u5[:np5], normals=z[:np5])
    c5_64 = (sp5.pre.cprime.double()[:, None]
             - sp5.pre.L2.double() @ z[:n5].double())
    b5_centre = float((c5[:n5].double() - c5_64).abs().max()) / r_pk
    del c5, c5_64
    b5_ok = (all(r["coeffs_differing"] <= MAX_COEFF_SHARE
                 and r["ties_off_by_one"] for r in (b5, b5_philox))
             and b5_centre <= MAX_PEIKERT_CENTRE_ERR)
    del z, u5, out, outp
    s.note("B5", max_abs_err=max(b5["max_abs_err"], b5_philox["max_abs_err"]),
           max_centre_err_over_r=b5_centre,
           coeffs_differing=max(b5["coeffs_differing"],
                                b5_philox["coeffs_differing"]),
           plain_ms=b5_plain_ms, check_ms=b5_ms,
           check_shape=f"{B} chains x {nr} rounds, window {ops_p.window}")

    b2w_ok, b2_wide = check_b2_ntru1024(s)
    b5w_ok, b5_wide = check_b5_wide(s)
    b6_ok, b6 = check_b6(s)
    qary_ok, qary = check_qary(s)
    cli_ok, cli_shapes = check_cli_shapes(s)
    mesh_ok, mesh_shapes = check_mesh_shapes(s)
    fp32_ok, fp32 = check_fp32_route(s)
    b7_ok, b7 = check_b7(s)
    b8_ok, b8 = check_b8(s)
    b1c_ok, b1c = check_b1_centred(s)
    points_ok, points = check_points(s)
    ok = (b1_ok and b1c_ok and b2_ok and b2w_ok and b3_ok and b4_ok
          and b5_ok and b5w_ok and b6_ok
          and qary_ok and cli_ok and mesh_ok and fp32_ok and b7_ok and b8_ok
          and points_ok)
    emit({"phase": "kernel_vs_plain", "ok": ok, "chains": B, "dim": n,
          "window": W, "plain_allow_tf32": False,
          "b1": dict(b1, max_kernel_centre_err_over_sigma=centre_b1,
                     max_abs_y=s.max_y("klein_draw"), **b1_is_b2),
          "b1_b6_b7_fp32_route": fp32, "b2_2steps": b2,
          "max_centre_err_over_sigma": centre,
          "max_kernel_centre_err_over_sigma": centre_kernel,
          "b2_hard_regime": dict(b2_hard, chains=HARD_CHECK_CHAINS,
                                 steps=HARD_CHECK_STEPS, sigma=HARD_SIGMA,
                                 window=ops2.window),
          "b2_b3_ntru1024": b2_wide,
          "b3_vs_b2": dict(b3_vs_b2, keep=B3_CHECK_KEEP, thin=B3_CHECK_THIN),
          "b3": dict(b3, keep=nk, thin=1, window=ops_h.window),
          "b4": dict(b4, steps=B4_CHECK_STEPS, window=ss.operands.window,
                     max_kernel_centre_err_over_sigma_prop=b4_centre),
          "b4_hard_regime": dict(b4_hard, chains=HARD_CHECK_CHAINS,
                                 steps=HARD_CHECK_STEPS,
                                 proposal_sigma=SMK_2D_PROPOSAL,
                                 window=s4.operands.window),
          "b5": dict(b5, rounds=nr, window=ops_p.window,
                     max_kernel_centre_err_over_r=b5_centre,
                     centre_gate=MAX_PEIKERT_CENTRE_ERR),
          "b5_philox": b5_philox, "b5_ntru1024": b5_wide, "b6": b6,
          "b1_b2_b5_b6_qary": qary, "b1_b2_cli_shapes": cli_shapes,
          "b1_b2_b5_mesh_shapes": mesh_shapes,
          "b7": b7, "b8": b8, "b1_centred": b1c, "points": points,
          "oks": {"b1": b1_ok, "b1_centred": b1c_ok,
                  "b1_b6_b7_fp32_route": fp32_ok,
                  "b2": b2_ok, "b2_b3_ntru1024": b2w_ok,
                  "b3": b3_ok, "b4": b4_ok, "b5": b5_ok,
                  "b5_ntru1024": b5w_ok, "b6": b6_ok,
                  "b1_b2_b5_b6_qary": qary_ok,
                  "b1_b2_cli_shapes": cli_ok,
                  "b1_b2_b5_mesh_shapes": mesh_ok, "b7": b7_ok, "b8": b8_ok,
                  "points": points_ok}})
    if not ok:
        fail("kernel_vs_plain", "kernel disagrees with its plain version")
    return s2, basis2


# ---------------------------------------------------------------- signing
def phase_signing(s: Smoke):
    """FalconSigner on NTRU-512 (the falcon512_sign benchmark cell's
    signer): SIGN_CALLS calls of SIGN_MESSAGES hashed messages, each call
    timed by CUDA events; every signature verified against the key's h and
    the bound; rows of the first call held to the float64 reference. Then
    centred B1 alone at a call's shape, and the redraw loop at scale: a
    signer whose bound, 2n sigma^2, fails about half the draws of every
    round, its signatures verified and held to the reference."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import FalconSigner, verify
    from lgbench import harness
    from lgbench.reference import sign as ref_sign
    kc = s.kc
    signer = FalconSigner(s.lat, SIGN_SIGMA, SIGN_Q, SIGN_BETA2,
                          tail_budget=SIGN_TAIL)
    with np.load(os.path.join(REPO, "bench_cache",
                              "ntru_512_12289_0_g.npz")) as key:
        h = key["h"]
    signer.sign(1, signer.hash_to_point(1, SIGN_MESSAGES))     # warm-up
    s.reset_counts()
    dim = s.lat.n
    ms, rounds, verified, norm2 = [], [], 0, 0.0
    first = None
    for k in range(SIGN_CALLS):
        seed = 2 ** 40 + 1_000_003 * k
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        c = signer.hash_to_point(seed, SIGN_MESSAGES)
        sig = signer.sign(seed, c)
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
        rounds.append(signer.redraw_rounds)
        verified += int(verify(h, c, sig, SIGN_Q, SIGN_BETA2).sum())
        norm2 += float((sig * sig).sum())
        if first is None:
            first = (seed, sig[:SIGN_REF_ROWS].clone())
    launches = s.counts()
    s.launches["signing"] = launches
    total = SIGN_CALLS * SIGN_MESSAGES
    norm_ratio = norm2 / (total * dim * SIGN_SIGMA ** 2)
    ref = ref_sign.Reference(s.lat.basis.cpu().numpy(), SIGN_SIGMA,
                             {"q": SIGN_Q, "beta2": SIGN_BETA2,
                              "tail_budget": SIGN_TAIL}, s.dev)
    seed, rows = first
    differ = harness.compare(rows, ref.expected(
        {"seed": torch.full((SIGN_REF_ROWS,), seed, dtype=torch.int64),
         "chain": torch.arange(SIGN_REF_ROWS)}))
    max_y = s.max_y("klein_draw_centred")
    # centred B1 alone on the last call's centres: U's fragments and U^T
    # read, the centres read and y and lw written once
    ops = signer.operands
    n_pad, W, B = ops.n_pad, ops.window, SIGN_MESSAGES
    _, cs = signer.centres(c.to(torch.float64))
    del c, sig
    kc.klein_draw_centred(ops, cs, seed=seed)
    ms_b1c = cuda_ms(lambda: kc.klein_draw_centred(ops, cs, seed=seed),
                     reps=3)
    del cs
    nbytes = 4 * (2 * n_pad * n_pad + 2 * n_pad + 2 * n_pad * B + B)
    s.note("B1c", ms=ms_b1c, **klein_bound(ops.n, W, B, nbytes),
           fp32_bound_ms=fp32_bound_ms(klein_flop(ops.n, W) * B, nbytes),
           shape=f"{B} chains, window {W}",
           sign_call_ms=sorted(ms)[len(ms) // 2])
    # the redraw loop at scale
    tight_beta2 = int(dim * SIGN_SIGMA ** 2)
    tight = FalconSigner(s.lat, SIGN_SIGMA, SIGN_Q, tight_beta2,
                         tail_budget=SIGN_TAIL)
    seed = 2 ** 41 + 7
    c = tight.hash_to_point(seed, SIGN_TIGHT_MESSAGES)
    sig = tight.sign(seed, c)
    tight_verified = int(verify(h, c, sig, SIGN_Q, tight_beta2).sum())
    ref_t = ref_sign.Reference(s.lat.basis.cpu().numpy(), SIGN_SIGMA,
                               {"q": SIGN_Q, "beta2": tight_beta2,
                                "tail_budget": SIGN_TAIL}, s.dev)
    tight_differ = harness.compare(sig[:SIGN_REF_ROWS], ref_t.expected(
        {"seed": torch.full((SIGN_REF_ROWS,), seed, dtype=torch.int64),
         "chain": torch.arange(SIGN_REF_ROWS)}))
    tight_res = {"messages": SIGN_TIGHT_MESSAGES, "beta2": tight_beta2,
                 "redraw_rounds": tight.redraw_rounds,
                 "verified": tight_verified,
                 "reference_rows_differ": tight_differ}
    ok = (verified == total and abs(norm_ratio - 1) < MAX_SIGN_NORM_GAP
          and 0 < max_y <= kc.EXACT_Y and signer.window == SIGN_WINDOW
          and differ <= SIGN_MAX_ROWS_DIFFER
          and launches["klein_draw_centred"] == SIGN_CALLS + sum(rounds)
          and tight.redraw_rounds >= SIGN_TIGHT_MIN_ROUNDS
          and tight_verified == SIGN_TIGHT_MESSAGES
          and tight_differ <= SIGN_MAX_ROWS_DIFFER)
    emit({"phase": "signing", "ok": ok, "calls": SIGN_CALLS,
          "messages": SIGN_MESSAGES, "window": signer.window,
          "verified": verified, "of": total,
          "norm2_over_dim_sigma2": norm_ratio, "max_abs_y": max_y,
          "redraw_rounds": rounds, "ms_per_call": ms,
          "reference_rows_differ": differ, "reference_rows": SIGN_REF_ROWS,
          "b1c_ms": ms_b1c, "b1c_bound_ms": s.k["B1c"]["bound_ms"],
          "tight_bound": tight_res, "launches": launches, "card": s.card})
    if not ok:
        fail("signing", "a signature failed verification, the law's second "
             "moment, the exact range, the reference or the redraw loop")


# ---------------------------------------------------------------- law
def law_zn(s: Smoke):
    """B8 through sample_zn (scalar sigma and centre): TVD to the exact pmf
    at sigma 2 and at sigma 1.5, centre 0.5."""
    from lattice_gaussian_mcmc_tpu_torch.samplers import sample_zn
    out = {}
    for name, seed, sigma, c in (("sigma2", 71, 2.0, 0.0),
                                 ("sigma1.5_c0.5", 72, 1.5, 0.5)):
        z = sample_zn(seed, 1, sigma, center=c, shape=(ZN_LAW_DRAWS,),
                      window=32, device=s.dev)
        out[name] = tvd_1d(z, sigma, c)
    out["draws"] = ZN_LAW_DRAWS
    out["ok"] = all(out[k] < MAX_TVD for k in ("sigma2", "sigma1.5_c0.5"))
    return out


def law_b6(s: Smoke, lat2, basis2):
    """B6 in 2D at sigma 2, 65,536 chains x 3 rounds on Philox: each
    round's coefficient means within 5 standard errors of 0 and standard
    deviations within 2% of sigma sqrt(diag((B^T B)^-1))."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    kc, B, R = s.kc, B6_MOMENT_CHAINS, B6_CHECK_ROUNDS
    ops = kc.kernel_operands(klein_precompute(lat2, 2.0))
    ring, _ = kc.klein_ring(ops, B, R, seed=73)
    X = kc.ring_coeffs(ops, ring).double()                  # (R, B, 2)
    b = np.asarray(basis2)
    target = torch.tensor(2.0 * np.sqrt(np.diag(np.linalg.inv(b.T @ b))),
                          device=s.dev)
    mean_se = (X.mean(dim=1).abs() / (target / math.sqrt(B))).max()
    std_gap = (X.std(dim=1) / target - 1.0).abs().max()
    return {"rounds": R, "chains": B,
            "max_mean_over_se": float(mean_se),
            "max_std_gap": float(std_gap),
            "ok": float(mean_se) < 5.0 and float(std_gap) < B6_STD_TOL}


def phase_law(s: Smoke, s2, basis2):
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        SMKSampler,
        UnifiedLatticeSampler,
    )
    X2 = s2.sample_iid(11, LAW_CHAINS, n_steps=LAW_STEPS, return_coeffs=True)
    tvd = tvd_2d(X2, basis2, HARD_SIGMA)
    acc2 = s2.acceptance_rate
    lat2 = s2.lattice
    sm = SMKSampler(lat2, HARD_SIGMA, proposal_sigma=SMK_2D_PROPOSAL)
    X4 = sm.sample_iid(12, LAW_CHAINS, n_steps=LAW_STEPS, return_coeffs=True)
    tvd_smk = tvd_2d(X4, basis2, HARD_SIGMA)
    zn = law_zn(s)
    b6 = law_b6(s, lat2, basis2)
    X = UnifiedLatticeSampler(lat2, sigma=2.0, algorithm="klein").sample(
        74, LAW_2D_CHAINS, return_coeffs=True)
    tvd_unified = tvd_2d(X, basis2, 2.0)
    del X
    ok = (tvd < MAX_TVD and abs(acc2 - HARD_ACCEPTANCE) < HARD_ACCEPTANCE_TOL
          and tvd_smk < MAX_TVD and zn["ok"] and b6["ok"]
          and tvd_unified < MAX_TVD)
    emit({"phase": "law", "ok": ok, "chains": X2.shape[0], "steps": LAW_STEPS,
          "window": s2.pre.window, "tvd": tvd, "acceptance": acc2,
          "expected_acceptance": HARD_ACCEPTANCE, "smk_tvd": tvd_smk,
          "smk_acceptance": sm.acceptance_rate,
          "smk_window": sm.operands.window, "b8_zn": zn, "b6_moments": b6,
          "unified_klein_tvd_sigma2": tvd_unified,
          "unified_klein_chains": LAW_2D_CHAINS})
    if not ok:
        fail("law", "2D hard regime off its target")


# ---------------------------------------------------------------- flagship
def phase_flagship(s: Smoke):
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import IMHKSampler
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        STEPS_PER_LAUNCH,
    )
    lat = s.lat
    s.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    # the sampler's automatic burn-in draws through B1 (one launch)
    sampler = IMHKSampler(lat, FALCON_SIGMA, tail_budget=0.01)
    rates, accs = [], []
    for rep in range(FLAGSHIP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = sampler.sample_iid(100 + rep, FLAGSHIP_CHAINS,
                               n_steps=STEPS_PER_LAUNCH, return_coeffs=True)
        torch.cuda.synchronize()
        rates.append(FLAGSHIP_CHAINS * STEPS_PER_LAUNCH
                     / (time.perf_counter() - t0))
        accs.append(sampler.acceptance_rate)
    launches = s.counts()
    s.launches["flagship"] = launches
    expected = dict(dict.fromkeys(launches, 0),
                    klein_draw=FLAGSHIP_REPS + 1, imhk_fused=FLAGSHIP_REPS)
    peak = torch.cuda.max_memory_allocated()
    n = lat.n
    # output check: shape, finite integers, and the D_{L,sigma} second
    # moment E||Bx||^2 ~ dim sigma^2 on a subset of chains
    finite = bool(torch.isfinite(X).all())
    integral = bool((X == torch.round(X)).all())
    v = X[:CHECK_CHAINS].double() @ lat.basis.T
    norm_ratio = float((v ** 2).sum(1).mean() / (n * FALCON_SIGMA ** 2))
    acc = sum(accs) / len(accs)
    ok = (tuple(X.shape) == (FLAGSHIP_CHAINS, n) and finite and integral
          and abs(norm_ratio - 1) < MAX_NORM_GAP and 0.99 < acc < 1.0
          and launches == expected)
    emit({"phase": "flagship", "ok": ok, "dim": n, "sigma": FALCON_SIGMA,
          "window": sampler.pre.window, "chains": FLAGSHIP_CHAINS,
          "steps_per_launch": STEPS_PER_LAUNCH, "reps": FLAGSHIP_REPS,
          "samples_per_s": len(rates) / sum(1 / r for r in rates),
          "rep_samples_per_s": rates, "acceptance": acc,
          "burn_in": sampler.burn_in, "launches": launches,
          "expected_launches": expected,
          "b1_max_abs_y": s.max_y("klein_draw"),
          "b2_max_abs_y": s.max_y("imhk_fused"),
          "peak_allocated_bytes": peak,
          "finite": finite, "integral": integral,
          "norm2_over_dim_sigma2": norm_ratio, "card": s.card})
    if not ok:
        fail("flagship", "flagship run failed its checks")
    return sampler


# ---------------------------------------------------------------- hard_regime
def phase_hard_regime(s: Smoke):
    """bench.py:136-217: B1 start, a B3 warm-up and a timed B3 run of
    T = 48 (lw ring only), the pooled ACF on the card to lag 24 and the
    Sokal tau_int, a warm-up and a timed 64-step B2 run."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.diagnostics import (
        pooled_acf,
        sokal_tau,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import IMHKSampler
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        STEPS_PER_LAUNCH,
    )
    kc = s.kc
    s.reset_counts()
    sampler = IMHKSampler(s.lat, s.sigma_row, tail_budget=0.01)
    ops = sampler.operands
    Bh, T, n = ROW_CHAINS, HARD_T, ops.n
    # the trajectory entry point, at a small size: Klein start (B1),
    # burn-in (B2), kept states (B3)
    Xs = sampler.sample(7, 4, thin=2, n_chains=CHECK_CHAINS,
                        return_coeffs=True)
    entry_ok = (tuple(Xs.shape) == (CHECK_CHAINS * 4, n)
                and bool(torch.isfinite(Xs).all())
                and sampler._last_state is not None)
    entry_acc = sampler.acceptance_rate
    del Xs
    seed = 100
    x, lw = kc.klein_draw(ops, Bh, seed=seed, step=0)
    acc = torch.zeros_like(lw)
    x, lw, acc, _, _ = kc.imhk_trajectory(ops, x, lw, acc, T, 1, seed=seed,
                                          step=1)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    x, lw, acc, _, tlw = kc.imhk_trajectory(ops, x, lw, acc, T, 1,
                                            seed=seed, step=1 + T)
    ev1.record()
    rho = pooled_acf(tlw, max_lag=HARD_MAX_LAG).cpu()
    dt_traj = time.perf_counter() - t0
    b3_ms = ev0.elapsed_time(ev1)
    ring_finite = bool(torch.isfinite(tlw).all())
    del tlw
    step = 1 + 2 * T
    kc.imhk_fused(ops, x, lw, acc, STEPS_PER_LAUNCH, seed=seed, step=step)
    acc = torch.zeros_like(lw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc.imhk_fused(ops, x, lw, acc, STEPS_PER_LAUNCH, seed=seed,
                  step=step + STEPS_PER_LAUNCH)
    a_h = float(acc.sum()) / (Bh * STEPS_PER_LAUNCH)   # synchronises
    sps = Bh * STEPS_PER_LAUNCH / (time.perf_counter() - t0)
    launches = s.counts()
    s.launches["hard_regime"] = launches
    tau = sokal_tau(rho)
    ess_per_sample = 1.0 / (2.0 * tau)
    n_pad, W = ops.n_pad, ops.window
    nbytes = 4 * (2 * n_pad * n_pad + 2 * n_pad
                  + 2 * (n_pad * Bh + 2 * Bh) + T * Bh)
    s.note("B3", ms=b3_ms, **klein_bound(n, W, Bh * T, nbytes),
           fp32_bound_ms=fp32_bound_ms(klein_flop(n, W) * Bh * T, nbytes),
           shape=f"{Bh} chains x {T} steps, window {W}, lw ring")
    ok = (entry_ok and ring_finite and bool(torch.isfinite(lw).all())
          and abs(a_h - HARD_ROW_ACCEPTANCE) <= ROW_ACCEPTANCE_TOL
          and 0.5 <= tau < HARD_MAX_LAG
          and all(launches[k] > 0 for k in ("klein_draw", "imhk_fused",
                                            "imhk_trajectory")))
    emit({"phase": "hard_regime", "ok": ok, "dim": n, "sigma": s.sigma_row,
          "sigma_over_max_gs": ROW_SIGMA_OVER_MAX_GS, "window": W,
          # B1-B3 compile windows 8, 16 and 24
          "window_path": "compiled" if W in (8, 16, 24) else "runtime",
          "chains": Bh, "traj_steps": T, "burn_in": sampler.burn_in,
          "samples_per_s": sps, "acceptance": a_h,
          "expected_acceptance": HARD_ROW_ACCEPTANCE,
          "tau_int": tau, "ess_per_sample": ess_per_sample,
          "ess_per_s": sps * ess_per_sample,
          "ess_per_s_independence_formula": sps * a_h / (2.0 - a_h),
          "samples_per_s_ring_plus_acf": Bh * T / dt_traj,
          "b3_ms": b3_ms, "b3_bound_ms": s.k["B3"]["bound_ms"],
          "pooled_acf": [float(r) for r in rho[:8]],
          "entry_sample_acceptance": entry_acc, "launches": launches,
          "b1_max_abs_y": s.max_y("klein_draw"),
          "b2_max_abs_y": s.max_y("imhk_fused"),
          "b3_max_abs_y": s.max_y("imhk_trajectory"), "card": s.card})
    if not ok:
        fail("hard_regime", "hard-regime row failed its checks")


# ---------------------------------------------------------------- smk
def phase_smk(s: Smoke):
    """bench.py:219-252: a Klein start and 32 SMK steps (through
    SMKSampler.sample_iid, the warm-up of the bench row), then 32 timed
    steps of B4 from there."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import SMKSampler
    kc, sc = s.kc, s.sc
    s.reset_counts()
    sampler = SMKSampler(s.lat, s.sigma_row,
                         proposal_sigma=SMK_PROPOSAL_OVER_SIGMA * s.sigma_row,
                         tail_budget=0.01)
    Bs, T = ROW_CHAINS, SMK_STEPS
    seed = 400
    X = sampler.sample_iid(seed, Bs, n_steps=T, return_coeffs=True)
    warm_acc = sampler.acceptance_rate
    ops = sampler.operands
    x = kc.to_kernel_layout(sampler.klein_operands, X)
    del X
    acc = torch.zeros(Bs, device=s.dev)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    sc.smk_steps(ops, x, acc, T, seed=seed, step=1 + T)
    ev1.record()
    a_s = float(acc.sum()) / (Bs * T)                   # synchronises
    sps = Bs * T / (time.perf_counter() - t0)
    b4_ms = ev0.elapsed_time(ev1)
    launches = s.counts()
    s.launches["smk"] = launches
    n, n_pad, W = ops.n, ops.n_pad, ops.window
    Xf = kc.from_kernel_layout(sampler.klein_operands, x)
    finite = bool(torch.isfinite(Xf).all())
    integral = bool((Xf == torch.round(Xf)).all())
    del x, Xf
    nbytes = 4 * (2 * n_pad * n_pad + 3 * n_pad + 2 * n_pad * Bs + 3 * Bs)
    s.note("B4", ms=b4_ms, **smk_bound(n, W, Bs * T, Bs, nbytes),
           fp32_bound_ms=fp32_bound_ms(
               T * smk_flop(n, W) * Bs + n * (n + 1) * Bs, nbytes),
           shape=f"{Bs} chains x {T} steps, window {W}")
    ok = (finite and integral
          and abs(a_s - SMK_ROW_ACCEPTANCE) <= ROW_ACCEPTANCE_TOL
          and launches["klein_draw"] > 0 and launches["smk_steps"] > 0)
    emit({"phase": "smk", "ok": ok, "dim": n, "sigma": s.sigma_row,
          "proposal_sigma": sampler.proposal_sigma, "window": W,
          "window_path": "compiled" if W in (8, 16, 24) else "runtime",
          "chains": Bs, "steps": T, "samples_per_s": sps,
          "acceptance": a_s, "expected_acceptance": SMK_ROW_ACCEPTANCE,
          "warm_up_acceptance": warm_acc, "b4_ms": b4_ms,
          "b4_bound_ms": s.k["B4"]["bound_ms"],
          "b1_max_abs_y": s.max_y("klein_draw"),
          "b4_max_abs_y": s.max_y("smk_steps"),
          "launches": launches, "card": s.card})
    if not ok:
        fail("smk", "SMK row failed its checks")


# ---------------------------------------------------------------- peikert
def phase_peikert(s: Smoke):
    """bench.py:254-296: PeikertSampler at 1.05 r s1(B), the window of
    suggest_peikert_window, 65,536 chains x 8 rounds in one B5 launch."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers import PeikertSampler
    pc = s.pc
    s.reset_counts()
    sigma, r, s1 = s.peikert_sigma()
    sampler = PeikertSampler(s.lat, sigma)
    ops = sampler.operands
    Bp, R, n = PEIKERT_CHAINS, PEIKERT_ROUNDS, ops.n
    # the sampler's entry point, one round
    pts = sampler.sample(500, CHECK_CHAINS)
    entry_ok = (tuple(pts.shape) == (CHECK_CHAINS, n)
                and bool(torch.isfinite(pts).all()))
    del pts
    pc.peikert_rounds(ops, Bp, R, seed=501)             # warm-up
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    ring = pc.peikert_rounds(ops, Bp, R, seed=502)
    ev1.record()
    torch.cuda.synchronize()
    sps = Bp * R / (time.perf_counter() - t0)
    b5_ms = ev0.elapsed_time(ev1)
    launches = s.counts()
    s.launches["peikert"] = launches
    X = pc.ring_coeffs(ops, ring)
    finite = bool(torch.isfinite(X).all())
    integral = bool((X == torch.round(X)).all())
    # D_{L,sigma} second moment on a subset of the last round's draws
    v = X[-1, :CHECK_CHAINS].double() @ s.lat.basis.T
    norm_ratio = float((v ** 2).sum(1).mean() / (n * sigma ** 2))
    del ring, X, v
    n_pad, W = ops.n_pad, ops.window
    nbytes = 4 * (n_pad * n_pad + n_pad + R * n_pad * Bp)
    s.note("B5", ms=b5_ms, **peikert_bound(n, W, Bp * R, nbytes),
           fp32_bound_ms=fp32_bound_ms(peikert_flop(n, W) * Bp * R, nbytes),
           shape=f"{Bp} chains x {R} rounds, window {W}")
    ok = (entry_ok and finite and integral and W == PEIKERT_WINDOW
          and abs(norm_ratio - 1) < MAX_NORM_GAP
          and launches["peikert_rounds"] > 0)
    emit({"phase": "peikert", "ok": ok, "dim": n, "sigma": sigma, "r": r,
          "s1": s1, "window": W,
          "window_path": "compiled" if W in (8, 16, 24) else "runtime",
          "chains": Bp, "rounds": R, "samples_per_s": sps,
          "norm2_over_dim_sigma2": norm_ratio, "b5_ms": b5_ms,
          "b5_bound_ms": s.k["B5"]["bound_ms"],
          "launches": launches, "card": s.card})
    if not ok:
        fail("peikert", "Peikert row failed its checks")


# -------------------------------------------------------- scale_validation
def scale_validation_expected(s: Smoke, sizes):
    """The launches of one `validate_scale.run_validation` at dimension
    1024: B1 a Klein batch (smooth, hard and its extra KS seeds, the SMK
    start), B2 one 16-step launch a Klein/IMHK regime, B4 one, B5 one; the
    float64 route none."""
    return dict(dict.fromkeys(s.counts(), 0), klein_draw=2 + sizes.ks_seeds,
                imhk_fused=2, smk_steps=1, peikert_rounds=1)


def phase_scale_validation(s: Smoke):
    """tools/validate_scale.py (the port of scripts/validate_pallas_scale.py)
    on NTRU-512 at its full sizes: B1 + B2 in the smooth (sigma 165.7) and
    hard (0.45 max ||b*_i||, 3 KS seeds) regimes, B1 + B4 (SMK), B5
    (Peikert), each against the per-row float64 route on the card. One line
    a gate, then the phase line; fails on any gate, on a launch count off
    the expected, or on a launch inside the float64 route."""
    from lattice_gaussian_mcmc_tpu_torch.tools import validate_scale as vs
    sizes = vs.Sizes()
    s.reset_counts()
    t0 = time.perf_counter()
    res = vs.run_validation(s.lat, 512, sizes, log=lambda msg: None)
    wall = time.perf_counter() - t0
    launches = s.counts()
    s.launches["scale_validation"] = launches
    for name in vs.REGIMES:
        for check, val in res[name].items():
            if isinstance(val, dict):
                emit({"phase": "scale_validation_gate", "regime": name,
                      "check": check, **val})
    expected = scale_validation_expected(s, sizes)
    vs.write_results(res, os.path.join(REPO, "suite_results",
                                       "torch_validation"))
    regimes = {k: res[k]["passed"] for k in vs.REGIMES}
    ok = res["all_passed"] and launches == expected
    emit({"phase": "scale_validation", "ok": ok, "dim": res["dim"],
          "passed": regimes, "f64_route_launches": res["f64_route_launches"],
          "windows": {k: res[k]["window"] for k in vs.REGIMES},
          "sigmas": {k: res[k]["sigma"] for k in vs.REGIMES},
          "f64_s": {"smooth": res["smooth"]["f64_klein_s"]
                    + res["smooth"]["f64_imhk_s"],
                    "hard": res["hard"]["f64_klein_s"]
                    + res["hard"]["f64_imhk_s"],
                    "smk": res["smk"]["f64_s"],
                    "peikert": res["peikert"]["f64_s"]},
          "wall_s": wall, "launches": launches,
          "expected_launches": expected, "card": s.card})
    if not ok:
        fail("scale_validation", "a kernel failed the float64 law at "
             "dimension 1024, or the launches are off")


# ---------------------------------------------------------------- suite
def phase_suite(s: Smoke):
    """experiments/benchmark.py run_benchmarks at BenchmarkConfig's default
    dimensions (16, 64, 256, 1024), all four rows at their default 65,536
    chains, 1 warm-up and 3 timed runs (the NTRU keys of seed 42 from
    bench_cache/ at 256 and 1024, the LLL-reduced q-ary bases below), and
    its reduction rows at 16, 64 and 256 on the native library. One line
    per row."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import benchmark
    from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
        BenchmarkConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.reduction import native_available
    if not native_available():
        fail("suite", "the native reduction library did not build")
    s.reset_counts()
    cfg = BenchmarkConfig(output_dir=os.path.join(REPO, "suite_results"),
                          cache_dir=os.path.join(REPO, "bench_cache"))
    t0 = time.perf_counter()
    payload = benchmark.run_benchmarks(cfg, device=s.dev)
    wall = time.perf_counter() - t0
    launches = s.counts()
    s.launches["suite"] = launches
    rows = payload["sampling"]
    for r in rows:
        emit({"suite_row": r["algorithm"], "dim": r["dimension"],
              "chains": r["chains"], "window": r["window"],
              "sigma": r["sigma"], "samples_per_run": r["samples_per_run"],
              "samples_per_s": r["samples_per_sec"],
              "p50_s": r["p50_s"], "min_s": r["min_s"], "max_s": r["max_s"],
              "peak_allocated_bytes": r.get("device_peak_bytes_allocated"),
              "norm2_over_dim_sigma2": r["norm2_over_dim_sigma2"],
              "max_abs_coeff": r["max_abs_coeff"]})
    for r in payload["reduction"]:
        emit({"suite_reduction_row": r})
    # the reduced q-ary bases behind the rows below 256 and the reduction
    # rows, by digest, to compare across hosts (the library is built with
    # -march=native)
    from lattice_gaussian_mcmc_tpu_torch.tools import reduction_digest
    emit({"suite_reduction_digests": reduction_digest.port_digests(),
          "host": reduction_digest.host()})
    klein = [r for r in rows if (r["algorithm"], r["dimension"])
             == ("klein", 1024)][0]
    qary = [r for r in rows if r["dimension"] < 256
            and r["algorithm"] != "direct"]
    red_ok = ([r["dimension"] for r in payload["reduction"]] == [16, 64, 256]
              and all(r["native"] and math.isfinite(r["lll_s"])
                      and math.isfinite(r["bkz20_s"])
                      for r in payload["reduction"]))
    ok = (payload["all_passed"] and len(rows) == 16 and red_ok
          and abs(klein["norm2_over_dim_sigma2"] - 1) < MAX_NORM_GAP
          and all(abs(r["norm2_over_dim_sigma2"] - 1) < MAX_NORM_GAP
                  for r in qary)
          and all(launches[k] > 0 for k in ("klein_ring", "klein_draw",
                                            "imhk_fused", "sample_zn_draws",
                                            "peikert_rounds")))
    emit({"phase": "suite", "ok": ok, "all_passed": payload["all_passed"],
          "rows": len(rows), "dims": list(cfg.dimensions),
          "reduction_rows": len(payload["reduction"]), "wall_s": wall,
          "klein_1024_norm2_over_dim_sigma2": klein["norm2_over_dim_sigma2"],
          "qary_norm2_over_dim_sigma2": {
              f"{r['algorithm']}{r['dimension']}": r["norm2_over_dim_sigma2"]
              for r in qary},
          "launches": launches,
          "b1_max_abs_y": s.max_y("klein_draw"),
          "b2_max_abs_y": s.max_y("imhk_fused"),
          "b6_max_abs_y": s.max_y("klein_ring"), "card": s.card})
    if not ok:
        fail("suite", "benchmark suite rows failed their checks")
    return rows


# ---------------------------------------------------------------- decode
def nearest_plane_parts(s: Smoke, t):
    """Lattice.nearest_plane's parts on targets t (B, n), in order, ms by
    CUDA events: B7's operands (with U's fragments), the float64 centres
    t Q / diag(R) and their recentring ct - U k (`babai_centres`), B7, and
    the coefficients' layout y^T + k."""
    import torch
    kc, lat = s.kc, s.lat
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    ops = kc.babai_operands(lat.Q, lat.R)
    kc.tc_fragments(ops)
    ev[1].record()
    centred, k = kc.babai_centres(ops, t)
    ev[2].record()
    y = kc.babai_decode(ops, centred)
    ev[3].record()
    y[:ops.n].T.to(torch.float64) + k
    ev[4].record()
    torch.cuda.synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(
        ("operands", "float64_centres", "b7", "layout"))}


def phase_decode(s: Smoke):
    """B7 through Lattice.nearest_plane on the NTRU-512 secret basis, 65,536
    targets B x* + w at two noise levels; annealed Gibbs through
    UnifiedLatticeSampler.decode on NTRU-64 (dimension 128), 64 targets,
    24 chains, 48 sweeps at two noise levels."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops import linalg
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        UnifiedLatticeSampler,
    )
    lat, T = s.lat, DECODE_TARGETS
    lat128 = ntru_lattice(64, q=12289, seed=0,
                          cache_dir=os.path.join(REPO, "bench_cache"),
                          device=s.dev)
    min_gs = float(lat128.gs_norms.min())
    gibbs_sets = [(rho, *decode_targets(lat128, GIBBS_TARGETS, rho, s.gen))
                  for rho in GIBBS_RHOS]
    # warm-up, outside the counts and the clock
    lat.nearest_plane(decode_targets(lat, 256, DECODE_RHOS[0], s.gen)[1])
    torch.cuda.synchronize()
    s.reset_counts()
    sets, res = [], {}
    for rho in DECODE_RHOS:
        xs, t = decode_targets(lat, T, rho, s.gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = lat.nearest_plane(t)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sets.append((rho, xs, t, X))
        res[f"rho{rho}"] = {"decodes_per_s": T / dt,
                            "decode_coords_per_s": T * lat.n / dt,
                            "seconds": dt,
                            "exact_x_star": int((X == xs).all(dim=1).sum())}
    gibbs_out = []
    for rho, xs_g, t_g in gibbs_sets:
        # sigma0 as experiments/decoding.py sets it
        sigma0 = max(1.5 * rho * min_gs, 0.3 * min_gs)
        facade = UnifiedLatticeSampler(lat128, sigma=sigma0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, Xg = facade.decode(91, t_g, stochastic=True,
                              n_chains=GIBBS_CHAINS, n_sweeps=GIBBS_SWEEPS)
        torch.cuda.synchronize()
        gibbs_out.append((sigma0, Xg, time.perf_counter() - t0))
    launches = s.counts()
    s.launches["decode"] = launches
    y_stats = s.kc.babai_y_stats()
    s.note("B7", max_abs_y=y_stats["max_abs_y"],
           beyond_256=y_stats["beyond_256"])
    # checks outside the path: the float64 oracle on a subset, C7, the
    # Babai baseline of the Gibbs targets
    breakdown = nearest_plane_parts(s, sets[-1][2])
    ops = s.kc.babai_operands(lat.Q, lat.R)
    for rho, xs, t, X in sets:
        r = res[f"rho{rho}"]
        sub = slice(0, DECODE_CHECK)
        Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t[sub])
        r["vs_float64_differing"], r["max_tie_distance"] = babai_ties(
            lat, t[sub], X[sub], Xo)
        X32 = decode_from_centres(s.kc, ops, f32_qr_centres(lat, t))
        r["c7_f32_qr_differing"] = int((X32 != X).any(dim=1).sum())
        r["c7_f32_qr_differing_from_float64_subset"] = int(
            (X32[sub] != Xo).any(dim=1).sum())
        del X32
    del sets
    margin = 2.0 * math.sqrt(0.25 / GIBBS_TARGETS)
    gibbs, gibbs_ok = {}, True
    for (rho, xs_g, t_g), (sigma0, Xg, dt_g) in zip(gibbs_sets, gibbs_out):
        Xb = lat128.nearest_plane(t_g)
        succ_b = float((Xb == xs_g).all(dim=1).double().mean())
        succ_g = float((Xg == xs_g).all(dim=1).double().mean())

        def dist2(X):
            return ((X.to(lat128.basis.dtype) @ lat128.basis.T - t_g)
                    ** 2).sum(1)

        # chain 0 starts at the Babai point and the closest point is kept,
        # so Gibbs is never farther; the sweeps must find closer points
        d2_b, d2_g = dist2(Xb), dist2(Xg)
        never_farther = bool((d2_g <= d2_b * (1 + 1e-12)).all())
        closer = int((d2_g < d2_b * (1 - 1e-12)).sum())
        gibbs[f"rho{rho}"] = {"sigma0": sigma0, "success_babai": succ_b,
                              "success_gibbs": succ_g,
                              "never_farther": never_farther,
                              "closer_than_babai": closer, "seconds": dt_g}
        gibbs_ok = (gibbs_ok and succ_g >= succ_b - margin and never_farther
                    and closer > 0)
    mid = gibbs[f"rho{GIBBS_RHOS[0]}"]["success_babai"]
    low = res[f"rho{DECODE_RHOS[0]}"]
    ok = (low["exact_x_star"] == T
          and all(r["vs_float64_differing"] == 0
                  or r["max_tie_distance"] <= BABAI_TIE_TOL
                  for r in res.values())
          and gibbs_ok and 0 < mid < 1
          and launches["babai_decode"] > 0)
    emit({"phase": "decode", "ok": ok, "dim": lat.n, "targets": T,
          "check_targets": DECODE_CHECK, "rhos": res,
          "tie_tol": BABAI_TIE_TOL, "b7_y": y_stats,
          "nearest_plane_parts_ms": breakdown,
          "gibbs": {"dim": lat128.n, "targets": GIBBS_TARGETS,
                    "chains": GIBBS_CHAINS, "sweeps": GIBBS_SWEEPS,
                    "margin": margin, "rhos": gibbs},
          "launches": launches, "card": s.card})
    if not ok:
        fail("decode", "decoding failed its checks")


# --------------------------------------------------------- captured chains
def chain_outputs(out):
    """The tensors of a chain function's result, its ChainState's too."""
    flat = []
    for o in out:
        if hasattr(o, "accepted"):
            flat += [o.coeffs, o.log_w, o.accepted]
        else:
            flat.append(o)
    return flat


def phase_captured_chains(s: Smoke):
    """Each plain chain function on the card, captured (one CUDA graph a
    step or sweep, replayed: `utils/graphs.py`), against its eager run (the
    same step bodies with the capture swapped for `graphs.EagerSteps`, what
    the CPU runs: `tools/captured_ab.py` `Eager`), bit for bit, on a short
    prefix at the drivers' shapes:
      imhk_chain             klein_validation's 2D hard regime ([[1, .5],
                             [0, 1]], sigma 0.35), one chain, 256 steps
      smk_chains             the same basis and sigma (proposal width
                             sigma), 8 chains, 64 steps
      gibbs_chain            run_decoding's channel lattice at n = 64, 24
                             chains from 0, 8 sweeps
      annealed_gibbs_decode  n = 64, 64 targets x 24 chains, 4 sweeps
      _mhk_decode_batch      n = 128, 64 targets, 8 steps
    with the replays each took and the ms a step of both runs (host clock,
    synchronised; the captured run's includes its warm-up step and its
    capture). Then the 2D IMHK step's replay alone, by CUDA events over
    1,000 replays, beside an eager step's."""
    import traceback

    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import decoding
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        annealed_gibbs_decode,
        gibbs_chain,
        imhk_chain,
        imhk_init,
        klein_precompute,
        smk_chains,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import _imhk_move
    from lattice_gaussian_mcmc_tpu_torch.tools.captured_ab import Eager
    graphs = s.graphs
    lat2 = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                              device=s.dev)
    pre2 = klein_precompute(lat2, CAPTURED_SIGMA)
    cfg = decoding.DecodingConfig()
    rng = np.random.default_rng(cfg.seed)
    lats = {n: decoding._channel_lattice(rng, n, s.dev) for n in (64, 128)}

    def targets(n, count):
        lat = lats[n]
        min_gs = float(lat.gs_norms.min())
        xs = rng.integers(-cfg.symbol_range, cfg.symbol_range + 1,
                          size=(count, n)).astype(np.float64)
        w = rng.normal(scale=CAPTURED_RHO * min_gs, size=(count, n))
        t = torch.as_tensor(xs @ lat.basis.cpu().numpy().T + w).to(s.dev)
        return lat, t, min_gs

    lat64, t64, gs64 = targets(64, CAPTURED_ANNEALED[0])
    lat128, t128, gs128 = targets(128, CAPTURED_MHK[0])
    sigma_w = CAPTURED_RHO * gs64
    C_smk, T_smk = CAPTURED_SMK
    C_g, S_g = CAPTURED_GIBBS_CHAIN
    _, C_a, S_a = CAPTURED_ANNEALED
    _, S_m = CAPTURED_MHK
    cases = [
        ("imhk_chain", CAPTURED_2D_STEPS,
         lambda: imhk_chain(pre2, CAPTURED_2D_STEPS, seed=45)),
        ("smk_chains", T_smk,
         lambda: smk_chains(pre2, lat2.Q, lat2.R, C_smk, T_smk, seed=46)),
        ("gibbs_chain", S_g,
         lambda: gibbs_chain(47, lat64, t64[0], sigma_w, S_g,
                             x0=torch.zeros(C_g, 64, device=s.dev))),
        ("annealed_gibbs_decode", S_a,
         lambda: annealed_gibbs_decode(
             48, lat64, t64, max(1.5 * sigma_w, 0.3 * gs64), n_sweeps=S_a,
             n_chains=C_a)),
        ("mhk_decode_batch", S_m,
         lambda: decoding._mhk_decode_batch(
             49, lat128, t128, 0.35 * gs128, n_steps=S_m,
             window=decoding.MHK_WINDOW)),
    ]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def compare(name, steps, fn):
        before = s.graph_counts()
        got, t_cap = timed(fn)
        after = s.graph_counts()
        captures = after["captures"] - before["captures"]
        replays = after["replays"] - before["replays"]
        with Eager(graphs):
            want, t_eager = timed(fn)
        eager_replays = s.graph_counts()["replays"] - after["replays"]
        a, b = chain_outputs(got), chain_outputs(want)
        equal = len(a) == len(b) and all(
            x.is_cuda and x.shape == y.shape and x.dtype == y.dtype
            and bool(torch.equal(x, y)) for x, y in zip(a, b))
        differing = [int((x != y).sum()) if x.shape == y.shape else -1
                     for x, y in zip(a, b)]
        rows[name] = {"steps": steps, "equal": equal,
                      "differing_entries": differing,
                      "captures": captures, "replays": replays,
                      "eager_replays": eager_replays,
                      "captured_ms_per_step": 1e3 * t_cap / steps,
                      "eager_ms_per_step": 1e3 * t_eager / steps}
        return (equal and captures == 1 and replays == steps
                and eager_replays == 0)

    def step_2d():
        # the 2D IMHK step alone: replays of one captured step, eager steps
        st = imhk_init(pre2, 1, seed=50)

        def move(step, *x):
            return _imhk_move(step, *x, pre2, 50, 0)

        g = graphs.StepGraph(move, (st.coeffs, st.log_w, st.accepted))
        g.replay(1)
        e = graphs.EagerSteps(move, (st.coeffs, st.log_w, st.accepted))
        e.replay(1)
        line["imhk_2d_step"] = {
            "replay_ms": cuda_ms(lambda: g.replay(CAPTURED_REPLAYS))
            / CAPTURED_REPLAYS,
            "eager_ms": cuda_ms(lambda: e.replay(100)) / 100,
            "replays_timed": CAPTURED_REPLAYS}
        return True

    # a sub-step's exception (a wrong step counter can index past the
    # annealing schedule, a device-side fault) is recorded, so the phase
    # line is always printed
    s.reset_counts()
    rows, errors = {}, {}
    line = {"phase": "captured_chains", "chains": rows, "errors": errors}
    ok = True
    for name, steps, fn in [*cases, ("imhk_2d_step", 0, None)]:
        try:
            ok = (compare(name, steps, fn) if fn else step_2d()) and ok
        except Exception:
            errors[name] = traceback.format_exc()[-3000:]
            ok = False
    launches = s.counts()
    s.launches["captured_chains"] = launches
    line.update(ok=ok, graphs=s.graph_counts(), launches=launches,
                card=s.card)
    emit(line)
    if not ok:
        fail("captured_chains", "a captured chain differs from its eager "
             "run, or did not run as one captured graph")


# ---------------------------------------------------------------- decoding
def phase_decoding(s: Smoke):
    """experiments/decoding.py run_decoding at DecodingConfig's defaults
    (LLL-reduced channel lattices of dimension 64 and 128, 64 targets at
    six noise levels; Babai through B7, annealed Gibbs 48 sweeps x 24
    chains, MHK 192 steps): its four gates and decodes/s per method. Then,
    outside the counts, B7 on the same instances (the same numpy stream)
    against the float64 nearest plane, up to counted ties."""
    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import decoding
    from lattice_gaussian_mcmc_tpu_torch.ops import linalg
    cfg = decoding.DecodingConfig(
        output_dir=os.path.join(REPO, "suite_results", "decoding"))
    s.reset_counts()
    t0 = time.perf_counter()
    out = decoding.run_decoding(cfg, device=s.dev)
    wall = time.perf_counter() - t0
    launches = s.counts()
    graph_counts = s.graph_counts()
    s.launches["decoding"] = launches
    rng = np.random.default_rng(cfg.seed)
    ties = {}
    for n in cfg.dimensions:
        lat = decoding._channel_lattice(rng, n, s.dev)
        basis = lat.basis.cpu().numpy()
        min_gs = float(lat.gs_norms.min())
        for rho in cfg.rho_grid:
            xs = rng.integers(-cfg.symbol_range, cfg.symbol_range + 1,
                              size=(cfg.n_targets, n)).astype(np.float64)
            w = rng.normal(scale=rho * min_gs, size=(cfg.n_targets, n))
            t = torch.as_tensor(xs @ basis.T + w).to(s.dev)
            X = lat.nearest_plane(t)
            Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t)
            ties[f"n{n}_rho{rho}"] = babai_ties(lat, t, X, Xo)
    babai_ok = all(d == 0 or tie <= BABAI_TIE_TOL for d, tie in ties.values())
    rates = {m: {f"n{r['n']}_rho{r['rho']}": r[f"decodes_per_sec_{m}"]
                 for r in out["rows"]} for m in ("babai", "gibbs", "mhk")}
    captured = graph_counts["replays"] > 0
    ok = (out["all_passed"] and babai_ok and launches["babai_decode"] > 0
          and captured)
    emit({"phase": "decoding", "ok": ok, "all_passed": out["all_passed"],
          "captured": captured, "graphs": graph_counts,
          "gates": out["gates"], "dims": list(cfg.dimensions),
          "targets": cfg.n_targets, "rhos": list(cfg.rho_grid),
          "success": [{k: r[k] for k in ("n", "rho", "success_babai",
                                         "success_gibbs", "success_mhk")}
                      for r in out["rows"]],
          "decodes_per_s": rates, "wall_s": wall,
          "b7_vs_float64_differing_and_tie": ties,
          "tie_tol": BABAI_TIE_TOL, "b7_y": s.kc.babai_y_stats(),
          "launches": launches, "backend": out["backend"], "card": s.card})
    if not ok:
        fail("decoding", "run_decoding failed its gates or B7 its oracle")


# -------------------------------------------------------------- validation
def phase_validation(s: Smoke):
    """experiments/klein_validation.py run_suite at its full budgets
    (experiment 1 draws through B8) and experiments/convergence_study.py
    run_study at ConvergenceConfig's defaults (CONVERGENCE_SAMPLES), on
    the card: all_passed and the wall time of each. Their chains are the
    plain per-row IMHK steps, one captured CUDA graph a step."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import (
        convergence_study,
        klein_validation,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
        ConvergenceConfig,
    )
    s.reset_counts()
    t0 = time.perf_counter()
    val = klein_validation.run_suite(
        output_dir=os.path.join(REPO, "suite_results", "klein_validation"),
        device=s.dev)
    wall_val = time.perf_counter() - t0
    cfg = ConvergenceConfig(
        output_dir=os.path.join(REPO, "suite_results", "convergence"),
        n_samples=CONVERGENCE_SAMPLES)
    t0 = time.perf_counter()
    study = convergence_study.run_study(cfg, device=s.dev)
    wall_study = time.perf_counter() - t0
    launches = s.counts()
    graph_counts = s.graph_counts()
    s.launches["validation"] = launches
    captured = graph_counts["replays"] > 0
    ok = (val["all_passed"] and study["all_passed"]
          and launches["sample_zn_draws"] > 0 and captured)
    emit({"phase": "validation", "ok": ok, "captured": captured,
          "graphs": graph_counts,
          "klein_validation": {k: {kk: v[kk] for kk in v
                                   if kk != "block_rates"}
                               for k, v in val.items() if isinstance(v, dict)},
          "klein_validation_all_passed": val["all_passed"],
          "klein_validation_wall_s": wall_val,
          "convergence_all_passed": study["all_passed"],
          "convergence_n_samples": cfg.n_samples,
          "algorithm_comparison": study["algorithm_comparison"],
          "dimension_scaling": study["dimension_scaling"],
          "tvd_decay_last": study["tvd_decay"][-1],
          "convergence_wall_s": wall_study, "launches": launches,
          "card": s.card})
    if not ok:
        fail("validation", "the Klein validation suite or the convergence "
             "study failed its gates")


# ---------------------------------------------------------------- cli
def cli_expected_launches(results):
    """The least launch counts of each experiment's kernels, from what it
    did (its payload): one B1 launch a blocked draw, one B2 launch a
    blocked step call, B4 one a window or probe, as the drivers make them
    at their defaults."""
    from lattice_gaussian_mcmc_tpu_torch.experiments.adaptation import (
        AdaptationConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
        ScalingConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.dimension_scaling \
        import ASYMPTOTIC_REPS
    sc = ScalingConfig()
    scaling_b1 = (4 * len(sc.dimensions)                     # throughput
                  + len([d for d in sc.dimensions if d <= 128])  # 1/delta
                  + 4                                        # condition
                  + 2 * len(sc.n_chains_grid)                # parallel
                  + (1 + ASYMPTOTIC_REPS)
                  * len(sc.asymptotic_dims))                 # asymptotics
    crypto = results["crypto"]["results"]
    evaluated = len([r for r in crypto["suite"].values()
                     if "skipped" not in r])
    sens = len(crypto["sigma_sensitivity"]) - 1      # less the gate row
    sensitivity = results["sensitivity"]["results"]
    sweep = len(sensitivity["sigma_sweep"]["rows"])
    reduced = len([r for r in sensitivity["reduction_sensitivity"]
                   if "skipped" not in r])
    centres = len(sensitivity["center_sensitivity"])
    windows = AdaptationConfig().n_windows
    return {"scaling": {"klein_draw": scaling_b1, "imhk_fused": 4},
            "crypto": {"klein_draw": evaluated + sens,
                       "imhk_fused": evaluated + sens},
            "sensitivity": {"klein_draw": sweep + reduced + centres,
                            "imhk_fused": sweep},
            "adaptation": {"klein_draw": 3, "smk_steps": windows + 2}}


def phase_cli(s: Smoke):
    """The port's CLI in-process at its defaults (not --quick):
    `cli.main(["--experiments", scaling, crypto, sensitivity, adaptation,
    "--output-dir", ...])` on the card. Checks exit 0, every experiment ok
    in run_summary.json, and each experiment's own launch counts (every
    count set to 0 before it and read after it) against the blocked draws,
    step calls and SMK windows it made: a blocked route that ran a plain
    version fails. One line: each experiment's wall seconds, the
    asymptotics (samples/s, B1's route and resources, the exponent), the
    adaptation (adapted width, acceptances, schedule, aggregate rate) and
    the crypto rows with the reduced q-ary bases' digests (hazard C12)."""
    import shutil
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import cli
    out_dir = os.path.join(REPO, "suite_results", "cli")
    shutil.rmtree(out_dir, ignore_errors=True)   # no merged old summary
    results, per = {}, {}
    run_experiment = cli.run_experiment

    def counted(name, output_dir, quick, cpu):
        s.reset_counts()
        try:
            r = run_experiment(name, output_dir, quick, cpu)
            results[name] = r
            return r
        finally:
            torch.cuda.synchronize()
            per[name] = s.counts()

    # the host's reduction seconds inside crypto and sensitivity
    from lattice_gaussian_mcmc_tpu_torch.experiments import (
        cryptographic,
        parameter_sensitivity,
    )
    reduction_s = {"crypto": 0.0, "sensitivity": 0.0}
    reducers = [(mod, name, getattr(mod, name), key)
                for mod, key in ((cryptographic, "crypto"),
                                 (parameter_sensitivity, "sensitivity"))
                for name in ("lll_reduce", "bkz_reduce")]

    def timed(fn, key):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                reduction_s[key] += time.perf_counter() - t
        return run

    cwd = os.getcwd()
    cli.run_experiment = counted
    for mod, name, fn, key in reducers:
        setattr(mod, name, timed(fn, key))
    try:
        os.chdir(REPO)    # the drivers read the NTRU keys of bench_cache/
        t0 = time.perf_counter()
        rc = cli.main(["--experiments", *CLI_EXPERIMENTS,
                       "--output-dir", out_dir])
        wall = time.perf_counter() - t0
    finally:
        cli.run_experiment = run_experiment
        for mod, name, fn, _ in reducers:
            setattr(mod, name, fn)
        os.chdir(cwd)
    s.launches["cli"] = {k: sum(c[k] for c in per.values())
                         for k in s.counts()}
    with open(os.path.join(out_dir, "run_summary.json")) as f:
        summary = {r["experiment"]: r for r in json.load(f)}
    ok = (rc == 0 and sorted(summary) == sorted(CLI_EXPERIMENTS)
          and all(r["ok"] and r["gates_passed"] for r in summary.values())
          and sorted(results) == sorted(CLI_EXPERIMENTS))
    line = {"phase": "cli", "rc": rc, "wall_s": wall,
            "summary": summary, "host_reduction_s": reduction_s,
            "launches": per, "card": s.card}
    if ok:
        expected = cli_expected_launches(results)
        line["expected_min_launches"] = expected
        ok = all(per[e][k] >= n > 0 for e, want in expected.items()
                 for k, n in want.items())
        scaling = results["scaling"]["results"]
        line["asymptotics"] = [
            {k: r.get(k) for k in ("dimension", "window", "chains",
                                   "samples_per_sec", "rep_times_s",
                                   "first_call_s",
                                   "n_pad", "route", "kernel_resources",
                                   "device_peak_bytes_allocated")}
            for r in scaling["asymptotics"]]
        line["complexity_exponent_fit"] = scaling["asymptotics"][-1][
            "complexity_exponent_fit"]
        line["complexity_gate"] = scaling["asymptotics"][-1][
            "complexity_gate"]
        line["throughput"] = scaling["throughput"]
        ad = results["adaptation"]["results"]
        line["adaptation"] = {k: ad[k] for k in (
            "sigma_target", "rwm_optimal_scaling_start",
            "sigma_prop_adapted", "acceptance_final",
            "acceptance_at_2x_width", "acceptance_at_half_width",
            "window_schedule", "samples_per_sec_aggregate",
            "samples_per_sec_last_window", "gates", "backend")}
        line["adaptation"]["history"] = [
            {k: h[k] for k in ("sigma_prop", "acceptance", "window_steps",
                               "window_s", "b4_window")}
            for h in ad["history"]]
        crypto = results["crypto"]["results"]
        line["crypto_rows"] = {
            name: {k: r.get(k) for k in (
                "dimension", "window", "acceptance",
                "coeff_std_over_expected", "window_clamped", "passed",
                "basis_digest", "skipped")}
            for name, r in crypto["suite"].items()}
        line["crypto_sigma_sensitivity"] = crypto["sigma_sensitivity"]
        line["sensitivity_phase_transition_at"] = results["sensitivity"][
            "results"]["sigma_sweep"]["phase_transition_at"]
        from lattice_gaussian_mcmc_tpu_torch.tools import reduction_digest
        line["host"] = reduction_digest.host()
    line["ok"] = ok
    emit(line)
    if not ok:
        fail("cli", "the CLI run failed, or a blocked route did not launch "
             "its kernels")


# ---------------------------------------------------------------- mesh
def mesh_expected_launches():
    """The least launches of the mesh phase's counted steps: the sharded
    flagship (B1, B2) and Peikert row (B5) and the world-size-1 digests'
    run (B1, B2, B5); the CLI's card rows, a warm-up and a timed run each
    (B1 2, B2 2, B5 2); klein_scaling one B1 draw a dimension."""
    return {"klein_draw": 1 + 1 + 2 + len(KLEIN_SCALING_DIMS),
            "imhk_fused": 1 + 1 + 2, "peikert_rounds": 1 + 1 + 2}


def phase_mesh(s: Smoke):
    """The port of parallel/ on the card.
    (a) World size 1 under NCCL: `sharded_imhk_blocked` on the flagship
        (524,288 chains, sigma 165.7, 64 B2 steps) equal bit for bit to the
        unsharded blocked route (coefficients, log-weights, accept counts),
        its all-reduced acceptance equal to the local one; `sharded_peikert`
        at the Peikert row (65,536 chains x 8 rounds) equal to
        `peikert_rounds`, its pooled moments to the local ones; B1/B2 (the
        route) and B5 by CUDA events beside the sharded calls.
    (b) Two gloo ranks on the card (`parallel/_multihost_worker.py`), each
        B1 + B2 and B5 on half of 65,536 flagship chains: the gathered
        digests equal world size 1's (under (a)'s group).
    (c) `cli.main(["--experiments", "mesh"])` at its defaults: exit 0 and
        all_passed (card rows at world size 1 under NCCL, 1/2/4/8 gloo CPU
        ranks, 1 and 2 processes).
    (d) The dry run on 2 ranks (gloo, CUDA tensors).
    (e) klein_scaling at dims 16-128 with 50,000 draws (B1), all_passed;
        ising_sample at 1024 x 1024 for 200 sweeps; gmrf_sample on a
        64 x 64 grid (E x^T Q x / n within 1%); a checkpoint round trip of
        a 4,096-chain flagship state; generate_tables on the cli phase's
        results. Every rank spawn has its own timeout."""
    import traceback

    import numpy as np
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import cli
    from lattice_gaussian_mcmc_tpu_torch.experiments.klein_scaling import (
        run_klein_scaling,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.reporting import (
        generate_tables,
    )
    from lattice_gaussian_mcmc_tpu_torch.models import (
        gmrf_precision,
        gmrf_sample,
        ising_sample,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel import (
        _multihost_worker,
        collectives,
        dryrun,
        runtime,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import all_reduce_sum
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        PeikertSampler,
        klein_precompute,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        STEPS_PER_LAUNCH,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
        imhk_steps_batch_blocked,
        klein_sample_batch_blocked,
    )
    from lattice_gaussian_mcmc_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    pc = s.pc
    C, T = FLAGSHIP_CHAINS, STEPS_PER_LAUNCH
    out_dir = os.path.join(REPO, "suite_results", "mesh")
    cache = os.path.join(REPO, "bench_cache")
    total = {k: 0 for k in s.counts()}
    graph_total = {k: 0 for k in s.graph_counts()}
    line = {"phase": "mesh", "errors": {}, "seconds": {}}
    checks = {}

    def counted(fn):
        """fn() on the main path: counts set to 0 before, read after."""
        s.reset_counts()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            for k, v in s.counts().items():
                total[k] += v
            for k, v in s.graph_counts().items():
                graph_total[k] += v

    def step(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            line["errors"][name] = traceback.format_exc()[-3000:]
            checks[name] = False
        line["seconds"][name] = time.perf_counter() - t0

    def world_1():
        pre = klein_precompute(s.lat, FALCON_SIGMA, tail_budget=0.01)
        sampler = PeikertSampler(s.lat, s.peikert_sigma()[0], device=s.dev)
        ops = sampler.operands
        # operands, fragments and guards built before the timed calls
        X0, lw0 = klein_sample_batch_blocked(pre, CHECK_CHAINS, seed=1)
        imhk_steps_batch_blocked(pre, X0, lw0, 1, seed=1, step=1)
        pc.peikert_rounds(ops, CHECK_CHAINS, 1, seed=1)
        runtime.init_runtime(f"tcp://127.0.0.1:{runtime.free_port()}", 1, 0,
                             device=s.dev)
        try:
            m = runtime.global_mesh(s.dev)
            line["world_1_backend"] = m.backend
            # NCCL sets up its communicator at the group's first collective
            t0 = time.perf_counter()
            all_reduce_sum(torch.zeros(1, device=s.dev), m)
            torch.cuda.synchronize()
            line["group_setup_s"] = time.perf_counter() - t0
            res = []

            def unsharded():
                r1, r2 = [], []
                b1 = cuda_ms(lambda: r1.append(klein_sample_batch_blocked(
                    pre, C, seed=MESH_SEED)))
                X0, lw0 = r1.pop()
                b2 = cuda_ms(lambda: r2.append(imhk_steps_batch_blocked(
                    pre, X0, lw0, T, seed=MESH_SEED, step=1)))
                return (b1, b2), r2.pop()

            t0 = time.perf_counter()
            ms = counted(lambda: cuda_ms(lambda: res.append(
                collectives.sharded_imhk_blocked(pre, C, T, m,
                                                 seed=MESH_SEED))))
            wall = time.perf_counter() - t0
            X, lw, acc, rate = res.pop()
            # the unsharded route on the same seed, B1 then B2
            (b1, b2), (Xu, lwu, accu) = unsharded()
            local = float(np.float32(int(accu.sum())) / np.float32(C * T))
            checks["flagship_equal"] = bool(
                torch.equal(X, Xu) and torch.equal(lw, lwu)
                and torch.equal(acc, accu))
            checks["flagship_acceptance"] = (rate == local
                                             and 0.99 < rate < 1.0)
            line["flagship"] = {"chains": C, "steps": T, "sharded_ms": ms,
                                "wall_s": wall,
                                "samples_per_s": C * T / wall,
                                "acceptance": rate, "local_acceptance": local,
                                "b1_route_ms": b1, "b2_route_ms": b2}
            s.note("B1", mesh_ms=b1)
            s.note("B2", mesh_ms=b2)
            state = {"coeffs": X[:CHECK_CHAINS].clone(),
                     "log_w": lw[:CHECK_CHAINS].clone(), "step": T}
            del X, lw, acc, Xu, lwu, accu
            torch.cuda.empty_cache()
            Bp, R = PEIKERT_CHAINS, PEIKERT_ROUNDS

            def rounds():
                ring = []
                b5 = cuda_ms(lambda: ring.append(pc.peikert_rounds(
                    ops, Bp, R, seed=MESH_SEED)))
                return b5, pc.ring_coeffs(ops, ring.pop()).transpose(
                    0, 1).reshape(Bp * R, ops.n)

            t0 = time.perf_counter()
            ms = counted(lambda: cuda_ms(lambda: res.append(
                collectives.sharded_peikert(ops, Bp, m, R, seed=MESH_SEED))))
            wall = time.perf_counter() - t0
            Xp, mean, var = res.pop()
            b5, want = rounds()
            mean_l = want.sum(0, dtype=torch.float64) / (Bp * R)
            var_l = (want.to(torch.float64).square_().sum(0) / (Bp * R)
                     - mean_l * mean_l)
            checks["peikert_equal"] = bool(
                torch.equal(Xp, want) and torch.equal(mean, mean_l)
                and torch.equal(var, var_l))
            line["peikert"] = {"chains": Bp, "rounds": R, "sharded_ms": ms,
                               "wall_s": wall,
                               "samples_per_s": Bp * R / wall,
                               "b5_ms": b5,
                               "pooled_var_max": float(var.max())}
            s.note("B5", mesh_ms=b5)
            del Xp, want, mean, var
            torch.cuda.empty_cache()
            line["world_1_digests"] = counted(
                lambda: _multihost_worker.run_paths(
                    m, "ntru", RANK_CHAINS, T, RANK_ROUNDS,
                    cache_dir=cache))
        finally:
            runtime.shutdown_runtime()
        # (e) a checkpoint round trip of a flagship state
        ck = os.path.join(out_dir, "checkpoint")
        save_checkpoint(ck, state, T)
        back, got_step = restore_checkpoint(ck, {
            "coeffs": torch.zeros(1, device=s.dev),
            "log_w": torch.zeros(1, device=s.dev), "step": 0})
        checks["checkpoint"] = (got_step == T and back["step"] == T and all(
            torch.equal(back[k], state[k]) for k in ("coeffs", "log_w")))

    def two_ranks():
        ranks = runtime.run_ranks(
            "lattice_gaussian_mcmc_tpu_torch.parallel._multihost_worker", 2,
            ["--device", s.dev.type, "--problem", "ntru", "--cache-dir", cache,
             "--chains", RANK_CHAINS, "--steps", T, "--rounds", RANK_ROUNDS,
             "--imhk-samples", 0], timeout=RANK_TIMEOUT_S)
        one = line["world_1_digests"]
        line["two_ranks"] = ranks
        checks["two_ranks_digests"] = all(
            r[p]["digest"] == one[p]["digest"]
            for r in ranks for p in ("blocked", "peikert"))
        checks["two_ranks_launched"] = all(
            r["backend"] == "gloo" and r["device"].startswith(s.dev.type)
            and r["launches"]["klein_draw"] > 0
            and r["launches"]["imhk_fused"] > 0
            and r["launches"]["peikert_rounds"] > 0 for r in ranks)

    def cli_mesh():
        import shutil
        shutil.rmtree(os.path.join(out_dir, "cli"), ignore_errors=True)
        rc = counted(lambda: cli.main(["--experiments", "mesh",
                                       "--output-dir",
                                       os.path.join(out_dir, "cli")]))
        with open(os.path.join(out_dir, "cli", "mesh",
                               "mesh_scaling.json")) as f:
            payload = json.load(f)
        line["cli"] = {"rc": rc, "all_passed": payload["all_passed"],
                       "card_rows": payload["card_rows"],
                       "cpu_rank_rows": {k: payload[k] for k in (
                           "rows", "pallas_rows", "peikert_rows")},
                       "process_rows": payload["process_rows"]}
        checks["cli"] = rc == 0 and payload["all_passed"] is True

    def dry_run():
        line["dryrun"] = dryrun.dryrun_multichip(2, s.dev,
                                                 timeout=RANK_TIMEOUT_S)
        checks["dryrun"] = line["dryrun"]["n_ranks"] == 2

    def rest():
        t0 = time.perf_counter()
        rows = counted(lambda: run_klein_scaling(
            KLEIN_SCALING_DIMS, KLEIN_SCALING_SAMPLES, KLEIN_SCALING_SEED,
            output_dir=os.path.join(out_dir, "klein_scaling"),
            make_plots=False, device=s.dev))
        line["klein_scaling"] = {
            "wall_s": time.perf_counter() - t0,
            "rows": [{k: r[k] for k in (
                "dimension", "sigma", "marginal_tvd_last_coord", "passed",
                "lll_s", "sample_s", "samples_per_sec")} for r in rows]}
        checks["klein_scaling"] = all(r["passed"] for r in rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spins, energy, mag = ising_sample(ISING_SHAPE, ISING_BETA,
                                          ISING_SWEEPS, seed=MESH_SEED,
                                          device=s.dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sites = ISING_SHAPE[0] * ISING_SHAPE[1]
        line["ising"] = {"shape": ISING_SHAPE, "sweeps": ISING_SWEEPS,
                         "beta": ISING_BETA, "wall_s": wall,
                         "site_updates_per_s": sites * ISING_SWEEPS / wall,
                         "energy_per_site": float(energy) / sites,
                         "magnetization": float(mag)}
        checks["ising"] = (bool(torch.isin(spins, spins.new_tensor(
            [-1.0, 1.0])).all()) and -2.0 <= float(energy) / sites <= 0.0
            and -1.0 <= float(mag) <= 1.0)
        Q = gmrf_precision(GMRF_GRID, device=s.dev)
        gen = torch.Generator(device=s.dev).manual_seed(MESH_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = gmrf_sample(Q, shape=(GMRF_SAMPLES,), generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        quad = float(((x @ Q) * x).sum(1).mean()) / Q.shape[0]
        line["gmrf"] = {"grid": GMRF_GRID, "samples": GMRF_SAMPLES,
                        "wall_s": wall, "samples_per_s": GMRF_SAMPLES / wall,
                        "quad_over_n": quad}
        checks["gmrf"] = (bool(torch.isfinite(x).all())
                          and abs(quad - 1) < MAX_GMRF_QUAD_GAP)
        tables = generate_tables(os.path.join(REPO, "suite_results", "cli"),
                                 os.path.join(out_dir, "tables"))
        line["tables"] = [os.path.basename(t) for t in tables]
        checks["tables"] = {"table_1_algorithm_comparison.tex",
                            "table_4_sigma_sensitivity.tex",
                            "table_5_scaling_analysis.tex"} <= set(
                                line["tables"])

    step("world_1", world_1)
    if "world_1" not in line["errors"]:
        step("two_ranks", two_ranks)
    step("cli", cli_mesh)
    step("dryrun", dry_run)
    step("rest", rest)
    s.launches["mesh"] = total
    expected = mesh_expected_launches()
    checks["launches"] = all(total[k] >= n > 0 for k, n in expected.items())
    # the CLI's per-row card row runs the plain chains as captured graphs
    checks["captured"] = graph_total["replays"] > 0
    ok = all(checks.values()) and not line["errors"]
    first = line.get("flagship", {})
    line.update(ok=ok, captured=checks["captured"], graphs=graph_total,
                checks=checks, launches=total,
                expected_min_launches=expected,
                samples_per_s=first.get("samples_per_s"),
                wall_s=sum(line["seconds"].values()), card=s.card)
    emit(line)
    if not ok:
        fail("mesh", "a sharded path disagreed with its unsharded route or "
             "world size 1, or a step of the phase failed")


# ---------------------------------------------------------------- timing
def time_b6_b7_b8(s: Smoke):
    """B6, B7 and B8 by CUDA events at the suite's and the decode phase's
    shapes (dimension 1024), each with its bound."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.experiments import benchmark
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
        suggest_peikert_window,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    kc, zc = s.kc, s.zc
    B = SUITE_CHAINS
    lat42 = ntru_lattice(512, q=12289, seed=42,
                         cache_dir=os.path.join(REPO, "bench_cache"),
                         device=s.dev)
    pre = klein_precompute(lat42, KLEIN_ROW_SIGMA_OVER_MAX_GS * float(
        lat42.gs_norms.max()), tail_budget=0.01)
    ops = kc.kernel_operands(pre)
    n, n_pad, W, R = ops.n, ops.n_pad, ops.window, benchmark.KLEIN_ROUNDS
    kc.klein_ring(ops, B, R, seed=5)
    ms6 = cuda_ms(lambda: kc.klein_ring(ops, B, R, seed=5), reps=3)
    nbytes = 4 * (2 * n_pad * n_pad + 2 * n_pad + R * (n_pad * B + B))
    s.note("B6", ms=ms6, **klein_bound(n, W, B * R, nbytes),
           fp32_bound_ms=fp32_bound_ms(klein_flop(n, W) * B * R, nbytes),
           shape=f"{B} chains x {R} rounds, window {W}")
    torch.cuda.empty_cache()
    lat = s.lat
    _, t = decode_targets(lat, DECODE_TARGETS, DECODE_RHOS[-1], s.gen)
    ops7 = kc.babai_operands(lat.Q, lat.R)
    ct, _ = kc.babai_centres(ops7, t)
    del t
    kc.babai_decode(ops7, ct)
    ms7 = cuda_ms(lambda: kc.babai_decode(ops7, ct), reps=3)
    T, np7 = DECODE_TARGETS, ops7.n_pad
    # ct read and y written (float32), U's three bf16 parts and U^T
    # (float32) read; the coupling's three bf16 passes on the tensor cores
    # and a subtraction and a rounding a coefficient
    nbytes = 4 * 2 * np7 * T + (3 * 2 + 4) * np7 * np7
    s.note("B7", ms=ms7,
           **bound(nbytes, tensor=3 * lat.n * (lat.n - 1) * T,
                   fp32=2 * lat.n * T),
           fp32_bound_ms=fp32_bound_ms(lat.n * (lat.n - 1) * T, nbytes),
           shape=f"{T} targets, dim {lat.n}")
    del ct
    num = B * n
    Wz = suggest_peikert_window(ZN_SIGMA, n)
    zc.sample_zn_draws(num, ZN_SIGMA, 0.0, Wz, seed=5, device=s.dev)
    ms8 = cuda_ms(lambda: zc.sample_zn_draws(num, ZN_SIGMA, 0.0, Wz, seed=5,
                                             device=s.dev), reps=3)
    # yardstick, used nowhere in the port: num draws of the same window
    # law by one library call, on its own random numbers
    _, cdf = zc.zn_cdf(ZN_SIGMA, 0.0, Wz, s.dev)
    w = torch.diff(cdf, prepend=cdf.new_zeros(1))
    torch.multinomial(w, num, replacement=True)
    lib8 = cuda_ms(lambda: torch.multinomial(w, num, replacement=True),
                   reps=3)
    s.note("B8", ms=ms8, **zn_bound(num), library_ms=lib8,
           library_call="torch.multinomial(window weights, num, "
                        "replacement=True)",
           shape=f"{num} draws, window {Wz}")
    torch.cuda.empty_cache()


def phase_timing(s: Smoke, sampler):
    """B1 and B2 against their plain versions on the same inputs at the
    flagship's shapes (524,288 chains; B2 as the main path launches it, 64
    steps), in-kernel Philox on both sides."""
    import torch
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        STEPS_PER_LAUNCH,
    )
    kc = s.kc
    Bf = FLAGSHIP_CHAINS
    ops = sampler.operands
    n, n_pad, W = ops.n, ops.n_pad, ops.window
    ms_b1 = cuda_ms(lambda: kc.klein_draw(ops, Bf, seed=7), reps=3)
    y, lw = kc.klein_draw(ops, Bf, seed=7)
    plain = []
    plain_b1 = cuda_ms(lambda: plain.extend(
        kc.klein_draw_plain(ops, Bf, seed=7)))
    cmp_b1 = compare_draws(y, plain[0], lw, plain[1], n)
    del plain
    x, lx, ax = y.clone(), lw.clone(), torch.zeros_like(lw)
    ms_b2 = cuda_ms(lambda: kc.imhk_fused(
        ops, x, lx, ax, STEPS_PER_LAUNCH, seed=7, step=1))
    xp, lxp, axp = y.clone(), lw.clone(), torch.zeros_like(lw)
    plain_b2 = cuda_ms(lambda: kc.imhk_fused_plain(
        ops, xp, lxp, axp, STEPS_PER_LAUNCH, seed=7, step=1))
    cmp_b2 = compare_steps(x, xp, lx, lxp, ax, axp, n, STEPS_PER_LAUNCH)
    del x, xp, y
    # a tie in any of the 64 proposals may re-route a chain's final state,
    # hence the looser chain share; the accept decisions are held chain by
    # chain and in total, which a kernel that never rejects would fail
    rej_p = cmp_b2["rejections_plain"]
    ok = (draws_ok(cmp_b1)
          and draws_ok(cmp_b2, max_chains=MAX_CHAIN_SHARE_DEEP)
          and cmp_b2["accept_differing"] <= MAX_ACCEPT_SHARE_DEEP
          and rej_p > 0 and abs(cmp_b2["rejections"] - rej_p)
          <= MAX_REJECTION_GAP * rej_p)
    bytes_b1 = 4 * (2 * n_pad * n_pad + 2 * n_pad + n_pad * Bf + Bf)
    bytes_b2 = 4 * (2 * n_pad * n_pad + 2 * n_pad + 2 * (n_pad * Bf + 2 * Bf))
    flop = klein_flop(n, W) * Bf
    shape = f"{Bf} chains, window {W}"
    s.note("B1", ms=ms_b1, plain_ms=plain_b1,
           **klein_bound(n, W, Bf, bytes_b1),
           fp32_bound_ms=fp32_bound_ms(flop, bytes_b1), shape=shape,
           max_abs_err=max(s.k["B1"]["max_abs_err"],
                           cmp_b1["max_abs_lw_err"]),
           coeffs_differing=max(s.k["B1"]["coeffs_differing"],
                                cmp_b1["coeffs_differing"]))
    s.note("B2", ms=ms_b2, plain_ms=plain_b2,
           **klein_bound(n, W, Bf * STEPS_PER_LAUNCH, bytes_b2),
           fp32_bound_ms=fp32_bound_ms(STEPS_PER_LAUNCH * flop, bytes_b2),
           shape=f"{shape} x {STEPS_PER_LAUNCH} steps",
           max_abs_err=max(s.k["B2"]["max_abs_err"],
                           cmp_b2["max_abs_lw_err"]),
           coeffs_differing=max(s.k["B2"]["coeffs_differing"],
                                cmp_b2["coeffs_differing"]),
           accept_differing=max(s.k["B2"]["accept_differing"],
                                cmp_b2["accept_differing"]))
    time_b6_b7_b8(s)
    emit({"phase": "timing", "ok": ok, "chains": Bf, "b1_vs_plain": cmp_b1,
          "b2_vs_plain": cmp_b2,
          "b3_to_b8": {k: s.k[k] for k in ("B3", "B4", "B5", "B6", "B7",
                                           "B8")},
          "card": s.card})
    if not ok:
        fail("timing", "kernel disagrees with its plain version at the "
             "flagship shapes")


KERNELS = [
    # (key, its wrapper: the launch record's name, label, source, replaces)
    ("B1", "klein_draw", "B1", "klein_tc.cu", "klein_pallas.py:642"),
    ("B1c", "klein_draw_centred", "centred B1", "klein_tc.cu",
     "klein_pallas.py:642"),
    ("B2", "imhk_fused", "B2", "imhk_tc.cu", "klein_pallas.py:798"),
    ("B3", "imhk_trajectory", "B3", "imhk_tc.cu", "klein_pallas.py:890"),
    ("B4", "smk_steps", "B4", "smk_tc.cu", "smk_pallas.py:439"),
    ("B5", "peikert_rounds", "B5", "peikert_tc.cu", "peikert_pallas.py:287"),
    ("B6", "klein_ring", "B6", "klein_tc.cu", "klein_pallas.py:714"),
    ("B7", "babai_decode", "B7", "klein_tc.cu", "klein_pallas.py:1027"),
    ("B8", "sample_zn_draws", "B8", "zn.cu", "zn_pallas.py:97"),
    # no TPU kernel: the JAX package leaves the points' product to XLA
    ("PTS", "points", "the lattice points x B^T", "points.cu", None),
]


def kernels_line(s: Smoke):
    """One entry per kernel: `launches` sums its counts over the path
    phases; `plain_ms` of B3-B8 is at the check size (`check_shape`, where
    `check_ms` is the kernel's own time), their `ms` at the row's shape.
    `fp32_route_launches` sums the paths' launches of klein.cu's FP32
    sweep, which B1, B6 and B7 take above n_pad 3,456 (0 for the rest)."""
    out = []
    for key, kernel, label, src, replaces in KERNELS:
        entry = {"name": f"{kernel} ({label})", "route": "cuda",
                 "source": f"lattice_gaussian_mcmc_tpu_torch/csrc/{src}",
                 "replaces": (f"lattice_gaussian_mcmc_tpu/ops/kernels/"
                              f"{replaces}" if replaces else None)}
        for field, suffix in (("launches", ""),
                              ("fp32_route_launches", "_fp32")):
            entry[field] = sum(c[kernel + suffix]
                               for c in s.launches.values())
        entry.update(s.k[key])
        entry.setdefault("library_ms", None)
        out.append(entry)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    s = Smoke()
    phase_toolchain(s)
    s2, basis2 = phase_kernel_vs_plain(s)
    phase_law(s, s2, basis2)
    del s2
    phase_captured_chains(s)
    sampler = phase_flagship(s)
    torch.cuda.empty_cache()
    phase_hard_regime(s)
    phase_smk(s)
    phase_peikert(s)
    torch.cuda.empty_cache()
    phase_scale_validation(s)
    torch.cuda.empty_cache()
    phase_suite(s)
    phase_decode(s)
    torch.cuda.empty_cache()
    phase_signing(s)
    torch.cuda.empty_cache()
    phase_decoding(s)
    phase_validation(s)
    torch.cuda.empty_cache()
    phase_cli(s)
    torch.cuda.empty_cache()
    phase_mesh(s)
    torch.cuda.empty_cache()
    phase_timing(s, sampler)
    kernels = kernels_line(s)
    if any(k["launches"] <= 0 for k in kernels):
        fail("kernels", "a kernel of the paths was never launched")
    print(s.card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
