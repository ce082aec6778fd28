"""CVP-decoding experiment: the MIMO lattice-decoding workload
(counterpart of the JAX package's `experiments/decoding.py`). Decode
success (exact recovery of the planted symbol vector) for

  babai   deterministic nearest plane, `Lattice.nearest_plane`: kernel B7
          on a card, its plain version on the CPU,
  gibbs   annealed Gibbs over the coefficient conditionals
          (`samplers/gibbs.py` `annealed_gibbs_decode`),
  mhk     an independent Metropolis-Hastings-Klein chain per target,
          targeting D_{Lambda, sigma, t}, keeping the closest visited point,

on an i.i.d.-Gaussian channel: B = LLL(H), H_ij ~ N(0, 1) at scale 64 and
rounded, planted x* uniform in [-S, S]^n, target t = B x* + w with
w ~ N(0, sigma_w^2 I). The noise grid is rho = sigma_w / min_i ||b*_i||:
Babai corrects up to (1/2) min ||b*_i||. The channel lattices and targets
come from `numpy.random.default_rng(cfg.seed)` in the JAX package's order,
so both packages decode the same instances.

Gates (as the JAX package's):
  - every method succeeds at the easiest noise level,
  - the stochastic decoders never lose to Babai by more than the Monte
    Carlo margin, and beat it somewhere where Babai fails (both start from
    the Babai point),
  - Babai's throughput is at least the reference's 500 decodes/s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ExperimentConfig,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.reduction import lll_reduce
from lattice_gaussian_mcmc_tpu_torch.samplers.gibbs import (
    annealed_gibbs_decode,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import _accept_uniform
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    klein_log_weight,
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.utils import graphs
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

MHK_WINDOW = 32


@dataclass
class DecodingConfig(ExperimentConfig):
    dimensions: Sequence[int] = (64, 128)
    n_targets: int = 64              # decoding instances per (n, rho) cell
    rho_grid: Sequence[float] = (0.05, 0.15, 0.25, 0.35, 0.45, 0.6)
    symbol_range: int = 2            # x* entries uniform in [-S, S]
    gibbs_sweeps: int = 48
    gibbs_chains: int = 24
    mhk_steps: int = 192
    output_dir: str = "results/decoding"


def _channel_lattice(rng: np.random.Generator, n: int, device=None):
    """LLL-reduced i.i.d. Gaussian channel basis (integerised at scale 64
    so the exact LLL applies, as a real MIMO detector would)."""
    H = rng.normal(size=(n, n)) * 64.0
    B = lll_reduce(np.round(H).astype(np.int64))
    return lattice_from_basis(np.asarray(B, dtype=np.float64), device=device)


def _mhk_decode_batch(seed: int, lat, targets, sigma, n_steps: int,
                      window: int):
    """Independent-MHK decode of targets (T, n): chain t targets
    D_{Lambda, sigma, t_t} with the scaled centre Q^T t_t / diag(R), starts
    at the Babai point and keeps the closest point it visits. Step s
    proposes the Klein draw of Philox step s, chain t. Returns (best
    coefficients (T, n), their squared distances (T,)). On a card a step
    is one captured CUDA graph, replayed (`utils/graphs.py`); the Babai
    start and its log-weight stay outside it."""
    pre0 = klein_precompute(lat, sigma, window=window)
    dt = pre0.U.dtype
    t = targets.to(dt)
    cs_t = (t @ lat.Q.to(dt)) / torch.diagonal(lat.R).to(dt)
    pre_t = dataclasses.replace(pre0, cs=cs_t)   # per-target log-weights
    T = t.shape[0]

    def d2(x):
        return ((x @ lat.basis.T.to(dt) - t) ** 2).sum(dim=1)

    def move(step, x, lw, best_x, best_d):
        y, lw_y = klein_sample_batch(pre0, T, seed=seed, step=step,
                                     centers=cs_t)
        u = _accept_uniform(seed, T, 0, step, dt, t.device)
        take = torch.log(u) < lw_y - lw
        x = torch.where(take[:, None], y, x)
        lw = torch.where(take, lw_y, lw)
        d = d2(x)
        better = d < best_d
        return (x, lw, torch.where(better[:, None], x, best_x),
                torch.where(better, d, best_d))

    x = lat.nearest_plane(t).to(dt)
    steps = graphs.stepper(move, (x, klein_log_weight(x, pre_t), x.clone(),
                                  d2(x)))
    steps.replay(n_steps)
    _, _, best_x, best_d = steps.state
    return best_x, best_d


def _success(X, xs) -> float:
    return float(np.mean(np.all(X.cpu().numpy() == xs, axis=1)))


def run_decoding(cfg: Optional[DecodingConfig] = None, device=None) -> Dict:
    """Every (dimension, rho) cell of `cfg` on `device` (the card unless
    asked), with the gates; writes `decoding_results.json` and the success
    plot to `cfg.output_dir`."""
    cfg = cfg or DecodingConfig()
    device = resolve_device(device)
    cfg.dump("decoding")
    rng = np.random.default_rng(cfg.seed)
    rows: List[Dict] = []
    rates: Dict[str, float] = {}

    for n in cfg.dimensions:
        lat = _channel_lattice(rng, n, device)
        min_gs = float(lat.gs_norms.min())
        basis = lat.basis.cpu().numpy()
        for ri, rho in enumerate(cfg.rho_grid):
            sigma_w = rho * min_gs
            xs = rng.integers(-cfg.symbol_range, cfg.symbol_range + 1,
                              size=(cfg.n_targets, n)).astype(np.float64)
            w = rng.normal(scale=sigma_w, size=(cfg.n_targets, n))
            targets = torch.as_tensor(xs @ basis.T + w).to(device)
            seed_cell = (cfg.seed << 16) + (n << 4) + ri

            # Babai, timed after a warm-up (the reference's decoder)
            lat.nearest_plane(targets)
            synchronize(device)
            t0 = time.perf_counter()
            xb = lat.nearest_plane(targets)
            synchronize(device)
            dt_b = max(time.perf_counter() - t0, 1e-9)
            succ_b = _success(xb, xs)

            # annealed Gibbs (sigma0 ~ the noise scale, from Babai)
            sigma0 = max(1.5 * sigma_w, 0.3 * min_gs)
            t0 = time.perf_counter()
            _, gx, _ = annealed_gibbs_decode(
                seed_cell, lat, targets, sigma0=sigma0,
                n_sweeps=cfg.gibbs_sweeps, n_chains=cfg.gibbs_chains)
            synchronize(device)
            dt_g = max(time.perf_counter() - t0, 1e-9)
            succ_g = _success(gx, xs)

            # independent MHK
            sigma_mhk = max(sigma_w, 0.35 * min_gs)
            t0 = time.perf_counter()
            mx, _ = _mhk_decode_batch(seed_cell + 1, lat, targets,
                                      sigma_mhk, n_steps=cfg.mhk_steps,
                                      window=MHK_WINDOW)
            synchronize(device)
            dt_m = max(time.perf_counter() - t0, 1e-9)
            succ_m = _success(mx, xs)

            rows.append({
                "n": int(n), "rho": float(rho), "sigma_w": float(sigma_w),
                "min_gs": min_gs,
                "success_babai": succ_b, "success_gibbs": succ_g,
                "success_mhk": succ_m,
                "decodes_per_sec_babai": cfg.n_targets / dt_b,
                "decodes_per_sec_gibbs": cfg.n_targets / dt_g,
                "decodes_per_sec_mhk": cfg.n_targets / dt_m,
            })
            rates["babai"] = max(rates.get("babai", 0.0),
                                 cfg.n_targets / dt_b)

    mc_margin = 2.0 * np.sqrt(0.25 / cfg.n_targets)  # 2 SE of a proportion
    easy = [r for r in rows if r["rho"] == min(cfg.rho_grid)]
    gate_easy = all(r["success_babai"] >= 0.99 and r["success_gibbs"] >= 0.99
                    and r["success_mhk"] >= 0.99 for r in easy)
    gate_never_lose = all(
        r["success_gibbs"] >= r["success_babai"] - mc_margin
        and r["success_mhk"] >= r["success_babai"] - mc_margin for r in rows)
    gate_beats_somewhere = any(
        (r["success_gibbs"] > r["success_babai"] + mc_margin / 2)
        or (r["success_mhk"] > r["success_babai"] + mc_margin / 2)
        for r in rows if r["success_babai"] < 0.995)
    gate_rate = rates.get("babai", 0.0) >= 500.0  # reference best CVP rate
    payload = {
        "rows": rows,
        "mc_margin": float(mc_margin),
        "gates": {
            "all_succeed_at_low_noise": bool(gate_easy),
            "stochastic_never_loses_to_babai": bool(gate_never_lose),
            "stochastic_beats_babai_midrange": bool(gate_beats_somewhere),
            "babai_rate_vs_reference_500ps": bool(gate_rate),
        },
        "all_passed": bool(gate_easy and gate_never_lose
                           and gate_beats_somewhere and gate_rate),
        "backend": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }
    out_dir = cfg.ensure_output()
    with open(os.path.join(out_dir, "decoding_results.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    _plot(rows, out_dir)
    return payload


def _plot(rows: List[Dict], out_dir: str) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    dims = sorted({r["n"] for r in rows})
    fig, axes = plt.subplots(1, len(dims), figsize=(5.2 * len(dims), 3.6),
                             squeeze=False)
    for ax, n in zip(axes[0], dims):
        sub = [r for r in rows if r["n"] == n]
        xs = [r["rho"] for r in sub]
        for m, style in (("babai", "o-"), ("gibbs", "s-"), ("mhk", "^-")):
            ax.plot(xs, [r[f"success_{m}"] for r in sub], style, label=m)
        ax.set_xlabel(r"noise $\rho = \sigma_w / \min\|b^*_i\|$")
        ax.set_ylabel("decode success rate")
        ax.set_title(f"MIMO CVP decoding, n={n}")
        ax.set_ylim(-0.03, 1.03)
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "decoding_success.png"), dpi=150)
    plt.close(fig)
