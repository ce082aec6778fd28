#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from `lattice_gaussian_mcmc_tpu_torch/csrc/` and
drives the port's main path: IMHK on the NTRU-512 secret basis (dimension
1024, sigma = FALCON-512's 165.7, window 16 from tail budget 0.01). Phases,
one JSON line each:

  toolchain        versions, the card, the kernel build
  kernel_vs_plain  B1 (Klein draw) and B2 (fused IMHK) against their plain
                   PyTorch versions on the card, on the caller's uniforms,
                   plus the f32 conditional-centre error against float64,
                   and B2 in the 2D hard regime, where it rejects
  law              2D hard regime: TVD to the enumerated target and the
                   stationary acceptance 0.9904
  flagship         IMHKSampler.sample_iid at 524,288 chains, 64 fused steps
                   per launch: samples/s, acceptance, launch counts
  timing           each kernel against its plain version at the flagship
                   shapes (draws, log-weights, accept decisions), and its
                   bound

then the card's name and power limit, a `kernels` line, and as the last
line {"ok": true, "device": {...}}. Any failed check exits non-zero before
the last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
MAX_TVD = 0.02
HARD_SIGMA = 0.35
HARD_ACCEPTANCE = 0.9904     # enumerated stationary acceptance, 2D hard regime
# 131,072 chains x 12 steps: binomial noise ~8e-5, so 2e-3 still tells a
# sampler that never rejects (1.0) from the law
HARD_ACCEPTANCE_TOL = 2e-3
HARD_CHECK_CHAINS = 65_536   # B2 vs plain in the hard regime
HARD_CHECK_STEPS = 4


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


def compare_draws(y, yp, lw, lwp, n, among=None):
    """Kernel vs plain on chain-minor draws (n_pad, B): the share of integer
    coefficients that differ, the share of chains that differ, whether each
    such chain (of those in the mask `among`) first differs, in its highest
    row, drawn first, by exactly one, and max |lw err| over the chains that
    agree."""
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
    same = ~chains
    lw_err = float((lw[same] - lwp[same]).abs().max()) if bool(same.any()) \
        else float("nan")
    return {"coeffs_differing": float(diff.float().mean()),
            "chains_differing": float(chains.float().mean()),
            "ties_off_by_one": ties_ok, "max_abs_lw_err": lw_err}


def compare_steps(x, xp, lx, lxp, ax, axp, n, n_steps):
    """compare_draws on B2's final states, plus its accept decisions: the
    share of chains whose acceptance counts differ, how many of the chains
    that agree in state differ in count, and the rejections on each side.
    A chain whose decisions differ holds another proposal altogether, so
    the off-by-one test covers the chains whose counts agree."""
    res = compare_draws(x, xp, lx, lxp, n, among=ax == axp)
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


def draws_ok(res, max_chains=MAX_CHAIN_SHARE):
    return (res["coeffs_differing"] <= MAX_COEFF_SHARE
            and res["chains_differing"] <= max_chains
            and res["ties_off_by_one"]
            and res["max_abs_lw_err"] <= MAX_LW_ERR)


def bound_ms(flop, nbytes):
    t_ops, t_bytes = flop / PEAK_FP32_S, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def klein_flop(n, window):
    # coupling: n(n-1)/2 FMAs (2 FLOP each); per row and window entry two
    # multiplies, an add, the exp, the CDF add and the compare
    return n * (n - 1) + 6 * n * window


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        lattice_from_basis,
        ntru_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        IMHKSampler,
        klein_precompute,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
        STEPS_PER_LAUNCH,
    )

    # the plain versions' matrix products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()

    # ---------------------------------------------------------------- toolchain
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    t0 = time.perf_counter()
    _build.load_klein()
    build_s = time.perf_counter() - t0
    ptxas = _build.BUILD_INFO.get("klein", {}).get("ptxas", "")
    emit({"phase": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1] if nvcc else None,
          "triton": has_triton, "card": card,
          "build_s": build_s,
          "ptxas": [ln.strip() for ln in ptxas.splitlines()
                    if "registers" in ln or "spill" in ln][:12]})

    # ---------------------------------------------------------- kernel_vs_plain
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device=dev)
    pre = klein_precompute(lat, FALCON_SIGMA, tail_budget=0.01)
    ops = klein_cuda.kernel_operands(pre)
    n, n_pad, W = ops.n, ops.n_pad, ops.window
    if (n, W) != (1024, 16):
        fail("kernel_vs_plain", f"expected dim 1024 window 16, got {n} {W}")
    gen = torch.Generator(device=dev).manual_seed(1234)
    B = CHECK_CHAINS
    u1 = torch.rand(n_pad, B, device=dev, generator=gen)
    y, lw = klein_cuda.klein_draw(ops, B, uniforms=u1)
    yp, lwp = klein_cuda.klein_draw_plain(ops, B, uniforms=u1)
    torch.cuda.synchronize()
    b1 = compare_draws(y, yp, lw, lwp, n)
    b2 = fused_vs_plain(ops, y, lw, 2, gen)
    # conditional centres of B1's draws: float32 from the kernel's operands
    # (recentered frame) against float64 from the float64 precomputation.
    # These are the plain version's centres; the kernel's own are held to
    # them by the tie gates above (a TF32 or bf16 coupling would move them
    # by ~1e-3 of |c| and flip a large share of the draws).
    c32 = ops.cs[:, None] - ops.U @ y + y
    x64 = (y + ops.shift[:, None]).double()
    c64 = pre.cs[:, None] - pre.U @ x64 + x64
    centre = float(((c32.double() + ops.shift.double()[:, None] - c64).abs()
                    / pre.sigmas[:, None]).max())
    # B2 where it rejects: the 2D hard regime (~1% of proposals rejected),
    # the operands of the law phase below, caller's uniforms
    basis2 = [[1.0, 0.5], [0.0, 1.0]]
    lat2 = lattice_from_basis(basis2, device=dev)
    s2 = IMHKSampler(lat2, HARD_SIGMA, burn_in=12)
    ops2 = s2.operands
    u0 = torch.rand(ops2.n_pad, HARD_CHECK_CHAINS, device=dev, generator=gen)
    y2, lw2 = klein_cuda.klein_draw(ops2, HARD_CHECK_CHAINS, uniforms=u0)
    b2_hard = fused_vs_plain(ops2, y2, lw2, HARD_CHECK_STEPS, gen)
    # every decision the kernel makes on a chain that agrees is the plain
    # version's, and the rejection totals differ by no more than the chains
    # re-routed by a tie
    n_tied = round(b2_hard["chains_differing"] * HARD_CHECK_CHAINS)
    hard_ok = (draws_ok(b2_hard) and b2_hard["rejections"] > 0
               and b2_hard["accept_differing_agreeing"] == 0
               and b2_hard["accept_differing"] <= MAX_ACCEPT_SHARE
               and abs(b2_hard["rejections"] - b2_hard["rejections_plain"])
               <= n_tied)
    ok = (draws_ok(b1) and draws_ok(b2) and centre < MAX_CENTRE_ERR
          and b2["accept_differing"] <= MAX_ACCEPT_SHARE
          and b2["accept_differing_agreeing"] == 0 and hard_ok)
    emit({"phase": "kernel_vs_plain", "ok": ok, "chains": B, "dim": n,
          "window": W, "plain_allow_tf32": False, "b1": b1, "b2_2steps": b2,
          "max_centre_err_over_sigma": centre,
          "b2_hard_regime": dict(b2_hard, chains=HARD_CHECK_CHAINS,
                                 steps=HARD_CHECK_STEPS, sigma=HARD_SIGMA,
                                 window=ops2.window)})
    if not ok:
        fail("kernel_vs_plain", "kernel disagrees with its plain version")
    del u1, y, yp, y2, u0

    # ---------------------------------------------------------------- law
    X2 = s2.sample_iid(11, 131_072, n_steps=12, return_coeffs=True)
    r = torch.arange(-8, 9, dtype=torch.float64, device=dev)
    grid = torch.cartesian_prod(r, r)          # row (a+8)*17 + (b+8)
    pts = grid @ torch.tensor(basis2, dtype=torch.float64, device=dev).T
    p = torch.softmax(-0.5 * (pts ** 2).sum(1) / HARD_SIGMA ** 2, dim=0)
    inside = (X2.abs() <= 8).all(dim=1)
    Xi = X2[inside].long() + 8
    emp = torch.bincount(Xi[:, 0] * 17 + Xi[:, 1], minlength=17 * 17)
    emp = emp.double() / X2.shape[0]
    tvd = 0.5 * float((emp - p).abs().sum()
                      + (1 - inside.double().mean()))
    acc2 = s2.acceptance_rate
    ok = tvd < MAX_TVD and abs(acc2 - HARD_ACCEPTANCE) < HARD_ACCEPTANCE_TOL
    emit({"phase": "law", "ok": ok, "chains": X2.shape[0], "steps": 12,
          "window": s2.pre.window, "tvd": tvd, "acceptance": acc2,
          "expected_acceptance": HARD_ACCEPTANCE})
    if not ok:
        fail("law", "2D hard regime off its target")
    del X2, s2

    # ---------------------------------------------------------------- flagship
    sampler = IMHKSampler(lat, FALCON_SIGMA, tail_budget=0.01)
    klein_cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
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
    launches = {"klein_draw": klein_cuda.klein_draw.launches,
                "imhk_fused": klein_cuda.imhk_fused.launches}
    peak = torch.cuda.max_memory_allocated()
    # output check: shape, finite integers, and the D_{L,sigma} second
    # moment E||Bx||^2 ~ dim sigma^2 on a subset of chains
    finite = bool(torch.isfinite(X).all())
    integral = bool((X == torch.round(X)).all())
    v = X[:CHECK_CHAINS].double() @ lat.basis.T
    norm_ratio = float((v ** 2).sum(1).mean() / (n * FALCON_SIGMA ** 2))
    acc = sum(accs) / len(accs)
    ok = (tuple(X.shape) == (FLAGSHIP_CHAINS, n) and finite and integral
          and abs(norm_ratio - 1) < 0.02 and 0.99 < acc < 1.0
          and all(c > 0 for c in launches.values()))
    emit({"phase": "flagship", "ok": ok, "dim": n, "sigma": FALCON_SIGMA,
          "window": sampler.pre.window, "chains": FLAGSHIP_CHAINS,
          "steps_per_launch": STEPS_PER_LAUNCH, "reps": FLAGSHIP_REPS,
          "samples_per_s": len(rates) / sum(1 / r for r in rates),
          "rep_samples_per_s": rates, "acceptance": acc,
          "launches": launches, "peak_allocated_bytes": peak,
          "finite": finite, "integral": integral,
          "norm2_over_dim_sigma2": norm_ratio, "card": card})
    if not ok:
        fail("flagship", "flagship run failed its checks")
    del X, v

    # ---------------------------------------------------------------- timing
    # Each kernel against its plain version on the same inputs at the
    # flagship's shapes (524,288 chains; B2 as the main path launches it,
    # 64 steps), in-kernel Philox on both sides.
    Bf = FLAGSHIP_CHAINS
    ops = sampler.operands
    ms_b1 = cuda_ms(lambda: klein_cuda.klein_draw(ops, Bf, seed=7), reps=3)
    y, lw = klein_cuda.klein_draw(ops, Bf, seed=7)
    plain = []
    plain_b1 = cuda_ms(lambda: plain.extend(
        klein_cuda.klein_draw_plain(ops, Bf, seed=7)))
    cmp_b1 = compare_draws(y, plain[0], lw, plain[1], n)
    del plain
    x, lx, ax = y.clone(), lw.clone(), torch.zeros_like(lw)
    ms_b2 = cuda_ms(lambda: klein_cuda.imhk_fused(
        ops, x, lx, ax, STEPS_PER_LAUNCH, seed=7, step=1))
    xp, lxp, axp = y.clone(), lw.clone(), torch.zeros_like(lw)
    plain_b2 = cuda_ms(lambda: klein_cuda.imhk_fused_plain(
        ops, xp, lxp, axp, STEPS_PER_LAUNCH, seed=7, step=1))
    cmp_b2 = compare_steps(x, xp, lx, lxp, ax, axp, n, STEPS_PER_LAUNCH)
    del x, xp
    # a tie in any of the 64 proposals may re-route a chain's final state,
    # hence the looser chain share; the accept decisions are held chain by
    # chain and in total, which a kernel that never rejects would fail
    rej_p = cmp_b2["rejections_plain"]
    ok = (draws_ok(cmp_b1)
          and draws_ok(cmp_b2, max_chains=MAX_CHAIN_SHARE_DEEP)
          and cmp_b2["accept_differing"] <= MAX_ACCEPT_SHARE_DEEP
          and rej_p > 0 and abs(cmp_b2["rejections"] - rej_p)
          <= MAX_REJECTION_GAP * rej_p)
    flop = klein_flop(n, W) * Bf
    bound_b1, by_b1 = bound_ms(flop, 4 * (2 * n_pad * n_pad + 2 * n_pad
                                          + n_pad * Bf + Bf))
    bound_b2, by_b2 = bound_ms(STEPS_PER_LAUNCH * flop,
                               4 * (2 * n_pad * n_pad + 2 * n_pad
                                    + 2 * (n_pad * Bf + 2 * Bf)))
    emit({"phase": "timing", "ok": ok, "chains": Bf, "b1_vs_plain": cmp_b1,
          "b2_vs_plain": cmp_b2, "card": card})
    if not ok:
        fail("timing", "kernel disagrees with its plain version at the "
             "flagship shapes")
    src = "lattice_gaussian_mcmc_tpu_torch/csrc/klein.cu"
    pallas = "lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py"
    kernels = [
        {"name": "klein_draw (B1)", "route": "cuda", "source": src,
         "replaces": f"{pallas}:642", "launches": launches["klein_draw"],
         "max_abs_err": max(b1["max_abs_lw_err"],
                            cmp_b1["max_abs_lw_err"]),
         "coeffs_differing": max(b1["coeffs_differing"],
                                 cmp_b1["coeffs_differing"]),
         "ms": ms_b1, "plain_ms": plain_b1, "bound_ms": bound_b1,
         "bound_by": by_b1, "library_ms": None},
        {"name": "imhk_fused (B2)", "route": "cuda", "source": src,
         "replaces": f"{pallas}:798", "launches": launches["imhk_fused"],
         "max_abs_err": max(b2["max_abs_lw_err"], b2_hard["max_abs_lw_err"],
                            cmp_b2["max_abs_lw_err"]),
         "coeffs_differing": max(b2["coeffs_differing"],
                                 b2_hard["coeffs_differing"],
                                 cmp_b2["coeffs_differing"]),
         "accept_differing": max(b2["accept_differing"],
                                 b2_hard["accept_differing"],
                                 cmp_b2["accept_differing"]),
         "steps_per_launch": STEPS_PER_LAUNCH,
         "ms": ms_b2, "plain_ms": plain_b2, "bound_ms": bound_b2,
         "bound_by": by_b2, "library_ms": None},
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
