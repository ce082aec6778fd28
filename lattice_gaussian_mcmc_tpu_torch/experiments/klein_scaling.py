"""Standalone Klein scaling-analysis pipeline (counterpart of the JAX
package's `experiments/klein_scaling.py`): for each n, a fixed-seed random
integer basis -> LLL (`reduction/`) -> GS profile -> sigma = 1.5 max
||b*_i|| -> a batch of Klein draws (kernel B1 on a card,
`klein_sample_batch_blocked`; its plain version on the CPU) -> the last
coordinate's 1D marginal against the exact windowed pmf -> CSV, JSON and,
with `make_plots`, plots.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)


def marginal_tvd(samples_1d: np.ndarray, center: float, sigma: float,
                 window: Optional[int] = None) -> float:
    """TVD between the empirical law of one coordinate and the exact
    windowed discrete Gaussian. The comparison window scales with sigma
    (>= 12 sigma wide, at least 40), so that the mass outside it stays
    negligible as sigma grows with the dimension."""
    if window is None:
        window = max(40, int(np.ceil(12.0 * sigma)))
    base = round(float(center))
    ks = np.arange(base - window // 2, base + window // 2 + 1)
    p = np.exp(-((ks - center) ** 2) / (2.0 * sigma ** 2))
    p /= p.sum()
    counts = np.array([(samples_1d == k).mean() for k in ks])
    out_of_window = 1.0 - counts.sum()
    return 0.5 * (np.abs(counts - p).sum() + out_of_window)


def stage_precompute(n: int, seed: int, entry_range: int = 50,
                     device=None):
    """A stage's sampler input: a full-rank random integer basis (entries
    in [0, entry_range]) -> LLL -> sigma = 1.5 max ||b*_i|| -> the Klein
    precomputation. Returns (pre, GS norms, generation s, LLL s)."""
    from lattice_gaussian_mcmc_tpu_torch.reduction import lll_reduce

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    while True:
        B = rng.integers(0, entry_range + 1, (n, n)).astype(np.float64)
        if abs(np.linalg.det(B)) > 0.5:
            break
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    R = lll_reduce(B)
    t_lll = time.perf_counter() - t0
    lat = lattice_from_basis(R, name=f"lll{n}", device=device)
    gs = lat.gs_norms.cpu().numpy().astype(np.float64)
    return klein_precompute(lat, 1.5 * float(gs.max())), gs, t_gen, t_lll


def analyze_dimension(n: int, n_samples: int, seed: int,
                      entry_range: int = 50, device=None) -> Dict:
    """One stage: basis -> LLL -> sigma -> draws -> marginal. The marginal
    under test is the last backward-substitution coordinate x_{n-1}: its
    conditional centre is fixed (cs_{n-1}), so its exact law is one 1D
    discrete Gaussian."""
    device = resolve_device(device)
    pre, gs, t_gen, t_lll = stage_precompute(n, seed, entry_range, device)
    sigma = 1.5 * float(gs.max())
    synchronize(device)
    t0 = time.perf_counter()
    X, _ = klein_sample_batch_blocked(pre, n_samples, seed=seed)
    X = X.cpu().numpy()
    t_sample = time.perf_counter() - t0
    sig_last = float(pre.sigmas[-1])
    c_last = float(pre.cs[-1])
    tvd = marginal_tvd(X[:, -1], c_last, sig_last)
    return {
        "dimension": n,
        "sigma": sigma,
        "max_gs_norm": float(gs.max()),
        "min_gs_norm": float(gs.min()),
        "gs_ratio": float(gs.max() / gs.min()),
        "n_samples": n_samples,
        "marginal_tvd_last_coord": float(tvd),
        "marginal_sigma": sig_last,
        "tvd_noise_floor": float(np.sqrt(41.0 / n_samples)),
        "passed": bool(tvd < max(0.02, 2.0 * np.sqrt(41.0 / n_samples))),
        "gen_s": t_gen, "lll_s": t_lll, "sample_s": t_sample,
        "samples_per_sec": n_samples / t_sample,
        "device": device.type,
    }


def run_klein_scaling(dims: Sequence[int] = (16, 32, 64, 128),
                      n_samples: int = 50_000, seed: int = 42,
                      output_dir: str = "results/klein_scaling",
                      make_plots: bool = True, device=None) -> List[Dict]:
    """Every dimension's row, written to klein_scaling.json (with
    all_passed) and .csv; returns the rows."""
    os.makedirs(output_dir, exist_ok=True)
    rows = [analyze_dimension(n, n_samples, seed, device=device)
            for n in dims]
    with open(os.path.join(output_dir, "klein_scaling.json"), "w") as f:
        json.dump({"rows": rows,
                   "all_passed": all(r["passed"] for r in rows)}, f,
                  indent=2, default=float)
    with open(os.path.join(output_dir, "klein_scaling.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    if make_plots:
        from lattice_gaussian_mcmc_tpu_torch.visualization import (
            PlottingTools,
        )
        pt = PlottingTools(output_dir)
        pt.scaling_plot(rows, "dimension", "samples_per_sec",
                        name="klein_scaling_throughput")
        pt.scaling_plot(rows, "dimension", "marginal_tvd_last_coord",
                        name="klein_scaling_tvd", loglog=False)
    return rows


if __name__ == "__main__":
    import sys
    out = run_klein_scaling()
    for r in out:
        print(f"n={r['dimension']}: tvd={r['marginal_tvd_last_coord']:.4f} "
              f"({'PASS' if r['passed'] else 'FAIL'}), "
              f"{r['samples_per_sec']:.0f} samples/s, "
              f"lll {r['lll_s']:.2f}s")
    sys.exit(0 if all(r["passed"] for r in out) else 1)
