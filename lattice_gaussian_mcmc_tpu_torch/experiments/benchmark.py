"""The benchmark suite: algorithms x dimensions, warm-up and timed runs,
and LLL/BKZ times (counterpart of the JAX package's
`experiments/benchmark.py` `bench_algorithm`, `bench_reduction` and
`run_benchmarks`).

Rows, at the default 65,536 chains. klein, imhk and peikert run at
n >= 256 on the NTRU secret basis (ring degree n/2, q 12289) at
sigma = 1.3 max ||b*_i||, below 256 on the LLL-reduced q-ary basis
`qary_lattice(n, n/2, q=3329)` at sigma = 1.5 max ||b*_i||; the window is
set by tail budget 0.01:
  klein    8 Klein rounds per chain in one launch (B6)
  imhk     a B1 start outside the timed region, then 16 fused IMHK steps
           per run (B2)
  direct   Z^n, sigma = 5, window suggest_peikert_window(5, n):
           chains x n i.i.d. draws (B8)
  peikert  PeikertSampler at 2 sigma s1(B) / max ||b*_i|| (at n >= 256
           sigma at least 1.05 r s1(B), Peikert's own floor): 8 rounds in
           one launch (B5) from n = 128 on; below, one `sample` round
           (B5) of min(chains, max(256, 2^28 // (n window))) draws, the
           JAX package's capped batch
`bench_reduction` times LLL, and BKZ-20 (2 tours) up to n = 256, on
`qary_lattice(n, n/2, q=3329)`; `run_benchmarks` adds its rows for
n <= 256.

Times: host clock around each run with `torch.cuda.synchronize()` before
each read; a row's rate is samples per run over the p50 of the timed runs.
Each row also reports, outside the timed region, the second moment
E||Bx||^2 / (dim sigma^2) of the first 4,096 chains of its last run
(about 1 at the sampler's law) and the largest |x| of that run.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    BenchmarkConfig,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    ntru_lattice,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import (
    identity_lattice,
    sample_zn,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    peikert_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
    suggest_peikert_window,
)
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.reduction import (
    bkz_reduce,
    lll_reduce,
    native_available,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    PeikertSampler,
    klein_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import memory_snapshot

KLEIN_ROUNDS = 8
IMHK_STEPS = 16
PEIKERT_ROUNDS = 8
DIRECT_SIGMA = 5.0
MOMENT_CHAINS = 4096
QARY_Q = 3329


def _time_fn(fn, warmup: int, runs: int, device: torch.device):
    """Stats of the timed runs' seconds, and the last run's output."""
    out = None
    for _ in range(warmup):
        out = None
        out = fn()
    times = []
    for _ in range(runs):
        out = None
        synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    arr = np.array(times)
    return {"mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "min_s": float(arr.min()), "max_s": float(arr.max())}, out


def _norm_ratio(coeffs, basis, sigma: float) -> float:
    """E ||B x||^2 / (dim sigma^2) over the first MOMENT_CHAINS rows."""
    x = coeffs[:MOMENT_CHAINS].to(torch.float64)
    v = x @ basis.to(torch.float64).T
    return float((v ** 2).sum(dim=1).mean() / (basis.shape[0] * sigma ** 2))


def bench_algorithm(algorithm: str, n: int, cfg: BenchmarkConfig,
                    seed: Optional[int] = None, device=None) -> Dict:
    """One (algorithm, dimension) row on `device` (the card unless
    asked)."""
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    B = cfg.n_chains
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    row = {"algorithm": algorithm, "dimension": n, "chains": B}

    if algorithm == "direct":
        sigma = DIRECT_SIGMA
        window = suggest_peikert_window(sigma, n)
        basis = identity_lattice(n, device=device).basis

        def run():
            return sample_zn(seed, n, sigma, shape=(B,), window=window,
                             device=device)

        per_run = B * n

        def coeffs(out):
            return out
    elif algorithm in ("klein", "imhk", "peikert"):
        if n >= 256:
            if n % 2:
                raise ValueError(
                    f"NTRU rows need an even dimension, got {n}")
            lat = ntru_lattice(n // 2, q=12289, seed=cfg.seed,
                               cache_dir=cfg.cache_dir, device=device)
            sigma_over_max_gs = 1.3
        else:
            lat = reduced_qary_lattice(n, cfg.seed, device)
            sigma_over_max_gs = 1.5
        basis = lat.basis
        max_gs = float(lat.gs_norms.max())
        sigma = sigma_over_max_gs * max_gs
        if algorithm == "peikert":
            s1 = float(np.linalg.norm(basis.cpu().numpy(), 2))
            if n >= 256:
                # Peikert needs sigma >= r s1(B), far above Klein's
                # operating point on the NTRU bases: the row runs at its
                # own floor
                sigma = max(sigma,
                            1.05 * smoothing_parameter_zn(n, 0.01) * s1)
            sampler = PeikertSampler(lat, 2.0 * sigma * s1 / max_gs,
                                     device=device)
            ops = sampler.operands
            sigma, window = sampler.sigma, ops.window
            if n >= 128:
                def run():
                    return peikert_cuda.peikert_rounds(
                        ops, B, PEIKERT_ROUNDS, seed=seed)

                per_run = B * PEIKERT_ROUNDS

                def coeffs(out):
                    return peikert_cuda.ring_coeffs(ops, out)[0]
            else:
                per_run = min(B, max(256, 2 ** 28
                                     // (n * sampler.pre.window)))

                def run():
                    return sampler.sample(seed, per_run, return_coeffs=True)

                def coeffs(out):
                    return out
        else:
            pre = klein_precompute(lat, sigma, tail_budget=1e-2)
            ops = klein_cuda.kernel_operands(pre)
            window = ops.window
            if algorithm == "klein":
                def run():
                    return klein_cuda.klein_ring(ops, B, KLEIN_ROUNDS,
                                                 seed=seed)

                per_run = B * KLEIN_ROUNDS

                def coeffs(out):        # round 0 of the ring
                    return klein_cuda.ring_coeffs(ops, out[0][:ops.n_pad])[0]
            else:
                # the start is a B1 draw at the row's seed, outside the
                # timed region; each run advances a copy of it
                x0, lw0 = klein_cuda.klein_draw(ops, B, seed=seed)

                def run():
                    x, lw = x0.clone(), lw0.clone()
                    acc = torch.zeros_like(lw)
                    return klein_cuda.imhk_fused(ops, x, lw, acc, IMHK_STEPS,
                                                 seed=seed, step=1)

                per_run = B * IMHK_STEPS

                def coeffs(out):
                    return klein_cuda.from_kernel_layout(ops, out[0])
    else:
        raise ValueError(f"unknown algorithm {algorithm}")

    stats, out = _time_fn(run, cfg.warmup_runs, cfg.timed_runs, device)
    row.update(sigma=sigma, window=window, samples_per_run=per_run,
               samples_per_sec=per_run / stats["p50_s"], **stats)
    x = coeffs(out)
    row["norm2_over_dim_sigma2"] = _norm_ratio(x, basis, sigma)
    row["max_abs_coeff"] = float(x.abs().max())
    del out, x
    row.update(memory_snapshot())
    return row


def reduced_qary_lattice(n: int, seed: int, device):
    """The LLL-reduced `qary_lattice(n, n/2, q=3329, seed)` of the rows
    below n = 256."""
    lat = qary_lattice(n, n // 2, q=QARY_Q, seed=seed, device="cpu")
    return lattice_from_basis(lll_reduce(lat.basis.numpy()),
                              name=lat.name + "-lll", device=device)


def bench_reduction(n: int, cfg: BenchmarkConfig) -> Dict:
    """LLL, and BKZ-20 (2 tours) up to n = 256, wall-clock on the host, on
    `qary_lattice(n, n/2, q=3329, cfg.seed)`."""
    B = qary_lattice(n, n // 2, q=QARY_Q, seed=cfg.seed,
                     device="cpu").basis.numpy()
    out = {"dimension": n, "native": native_available()}
    t0 = time.perf_counter()
    R = lll_reduce(B)
    out["lll_s"] = time.perf_counter() - t0
    if native_available() and n <= 256:
        t0 = time.perf_counter()
        bkz_reduce(R, beta=20, max_tours=2)
        out["bkz20_s"] = time.perf_counter() - t0
    return out


def _row_seed(cfg: BenchmarkConfig, algorithm: str) -> int:
    return cfg.seed + zlib.crc32(algorithm.encode())


def run_benchmarks(cfg: Optional[BenchmarkConfig] = None,
                   device=None) -> Dict:
    """Every (dimension, algorithm) row of `cfg`, and the reduction rows
    for dimensions up to 256, written with the gate `all_passed` (every
    sampling row a finite positive rate) to
    `cfg.output_dir/benchmark_results.json`."""
    cfg = cfg or BenchmarkConfig()
    device = resolve_device(device)
    out_dir = cfg.ensure_output()
    results: List[Dict] = []
    for n in cfg.dimensions:
        for alg in cfg.algorithms:
            results.append(bench_algorithm(alg, n, cfg, _row_seed(cfg, alg),
                                           device))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    red = [bench_reduction(n, cfg) for n in cfg.dimensions if n <= 256]
    payload = {"sampling": results, "reduction": red,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else str(device))}
    payload["all_passed"] = bool(
        results and all(np.isfinite(r["samples_per_sec"])
                        and r["samples_per_sec"] > 0 for r in results))
    with open(os.path.join(out_dir, "benchmark_results.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    return payload
