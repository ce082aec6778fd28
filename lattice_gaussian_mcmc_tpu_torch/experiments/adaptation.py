"""Symmetric Metropolis-Klein with sigma adaptation on an NTRU lattice, end
to end (counterpart of the JAX package's `experiments/adaptation.py`).

The chain is the Wang-Ling symmetric Metropolis-Klein variant (a Klein
proposal centred at the current point); the adapted parameter is the
proposal width sigma_prop, driven by Robbins-Monro on the windowed pooled
acceptance of the whole chain batch (`samplers/adaptation.py`
`adapt_sigma_smk`). On a card every window is one launch of kernel B4 after
one Klein start on B1; on the CPU the plain per-row `smk_step` runs the
same law.

Gates:
  - converged: pooled acceptance of the last window within +-0.08 of the
    target,
  - responsive: acceptance at 2x the adapted width is lower, at 0.5x
    higher (probed from fresh Klein starts at fixed widths),
  - stationary width: the last-3-window sigma_prop spread is < 20%.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ExperimentConfig,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
from lattice_gaussian_mcmc_tpu_torch.samplers import adaptation
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device

# the probes' seeds: cfg.seed + PROBE_SEED (2x) and + PROBE_SEED + 1 (0.5x)
PROBE_SEED = 0xbeef


@dataclass
class AdaptationConfig(ExperimentConfig):
    ntru_n: int = 512                # ring degree (lattice dim = 2n)
    ntru_q: int = 12289
    sigma_factor: float = 1.0        # target sigma = factor * max||b*_i||
    target_acceptance: float = 0.45
    n_chains: int = 65536
    n_windows: int = 16
    window_steps: int = 8
    # diminishing adaptation: after `warmup_windows` the per-window step
    # count jumps once to `max_window_steps` (see adapt_sigma_smk)
    grow_windows: bool = True
    warmup_windows: int = 5
    max_window_steps: int = 256
    output_dir: str = "results/adaptation"
    cache_dir: str = "bench_cache"


def _probe_acceptance(lattice, sigma: float, sigma_prop: float,
                      n_chains: int, steps: int, seed: int) -> float:
    """Pooled SMK acceptance at a FIXED proposal width from a fresh Klein
    start at `seed`: `adapt_sigma_smk`'s first window alone (on a card a
    B1 start and one B4 launch of `steps` steps)."""
    st = adaptation.adapt_sigma_smk(lattice, sigma, sigma_prop0=sigma_prop,
                                    n_windows=1, window_steps=steps,
                                    n_chains=n_chains, grow_windows=False,
                                    seed=seed)
    return st.history[0]["acceptance"]


def run_adaptation(cfg: Optional[AdaptationConfig] = None,
                   device=None) -> Dict:
    """Adapt sigma_prop on the NTRU lattice of ring degree cfg.ntru_n (the
    cached key of cfg.seed) at sigma = sigma_factor max||b*_i||, on
    `device` (the card unless asked); probe the adapted width at 2x and
    0.5x; gate; write `adaptation_ntru.json` and, with matplotlib, the
    trace plot."""
    cfg = cfg or AdaptationConfig()
    device = resolve_device(device)
    cfg.dump("adaptation")
    lat = ntru_lattice(cfg.ntru_n, q=cfg.ntru_q, seed=cfg.seed,
                       cache_dir=cfg.cache_dir, device=device)
    sigma = cfg.sigma_factor * float(torch.max(lat.gs_norms))
    on_card = device.type == "cuda"

    st = adaptation.adapt_sigma_smk(
        lat, sigma, target_acceptance=cfg.target_acceptance,
        n_windows=cfg.n_windows, window_steps=cfg.window_steps,
        n_chains=cfg.n_chains, grow_windows=cfg.grow_windows,
        warmup_windows=cfg.warmup_windows,
        max_window_steps=cfg.max_window_steps, seed=cfg.seed)

    final = st.history[-1]
    sigma_star = final["sigma_prop"]
    acc_star = final["acceptance"]
    # RWM response curve: acceptance must fall when the width doubles and
    # rise when it halves (probed with fresh batches at fixed widths)
    acc_2x = _probe_acceptance(lat, sigma, 2.0 * sigma_star, cfg.n_chains,
                               cfg.window_steps, cfg.seed + PROBE_SEED)
    acc_half = _probe_acceptance(lat, sigma, 0.5 * sigma_star, cfg.n_chains,
                                 cfg.window_steps,
                                 cfg.seed + PROBE_SEED + 1)
    tail = [h["sigma_prop"] for h in st.history[-3:]]
    spread = (max(tail) - min(tail)) / max(sigma_star, 1e-12)
    gates = {
        "converged_to_target": bool(
            abs(acc_star - cfg.target_acceptance) <= 0.08),
        "acceptance_monotone_in_width": bool(
            acc_2x < acc_star < acc_half),
        "width_stationary": bool(spread < 0.20),
    }
    payload = {
        "lattice": {"kind": "ntru", "n_ring": cfg.ntru_n,
                    "dim": 2 * cfg.ntru_n, "q": cfg.ntru_q},
        "sigma_target": sigma,
        "sigma_over_max_gs": cfg.sigma_factor,
        "target_acceptance": cfg.target_acceptance,
        "backend": "cuda_b4" if on_card else "plain",
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
        "rwm_optimal_scaling_start": 2.38 * sigma / math.sqrt(lat.n),
        "history": st.history,
        "sigma_prop_adapted": sigma_star,
        "acceptance_final": acc_star,
        "acceptance_at_2x_width": acc_2x,
        "acceptance_at_half_width": acc_half,
        "samples_per_sec_last_window": final["samples_per_sec"],
        "samples_per_sec_aggregate": cfg.n_chains * sum(
            h["window_steps"] for h in st.history) / max(
            sum(h["window_s"] for h in st.history), 1e-9),
        "window_schedule": [h["window_steps"] for h in st.history],
        "rate_note": ("per-window rates include one host synchronisation "
                      "and one launch per window; growing windows "
                      "(diminishing adaptation) amortise them"),
        "gates": gates,
        "all_passed": bool(all(gates.values())),
    }
    out_dir = cfg.ensure_output()
    with open(os.path.join(out_dir, "adaptation_ntru.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    _plot(st.history, cfg.target_acceptance, out_dir)
    return payload


def _plot(history, target, out_dir: str) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    w = [h["window"] for h in history]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.2, 3.4))
    ax1.plot(w, [h["acceptance"] for h in history], "o-")
    ax1.axhline(target, ls="--", c="k", lw=1, label="target")
    ax1.set_xlabel("adaptation window")
    ax1.set_ylabel("pooled acceptance")
    ax1.legend()
    ax1.grid(alpha=0.3)
    ax2.semilogy(w, [h["sigma_prop"] for h in history], "s-")
    ax2.set_xlabel("adaptation window")
    ax2.set_ylabel(r"proposal width $\sigma_{prop}$")
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "adaptation_trace.png"), dpi=150)
    plt.close(fig)
