"""Quickstart: sample a discrete Gaussian over a q-ary lattice (the port
of the JAX package's `examples/quickstart.py`).

    python -m lattice_gaussian_mcmc_tpu_torch.examples.quickstart [--cpu]
        [--n 64] [--samples 10000]

Runs on the CUDA card (IMHK's trajectory through kernels B1-B3) unless
`--cpu` is given, where their plain versions run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=64, help="lattice dimension")
    ap.add_argument("--samples", type=int, default=10_000)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    import lattice_gaussian_mcmc_tpu_torch as lg
    from lattice_gaussian_mcmc_tpu_torch.diagnostics import (
        effective_sample_size,
    )
    from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (
        spectral_gap_mc,
    )
    from lattice_gaussian_mcmc_tpu_torch.reduction import lll_reduce
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_sample_batch

    # 1. build a random q-ary (LWE-style) lattice and LLL-reduce it
    lat = lg.qary_lattice(n=args.n, k=args.n // 2, q=3329, seed=0,
                          device=device)
    lat = lg.lattice_from_basis(lll_reduce(lat.basis.cpu().numpy()),
                                name=f"qary{args.n}-lll", device=device)
    max_gs = float(torch.max(lat.gs_norms))
    sigma = 1.5 * max_gs
    print(f"lattice {lat.name}: max||b*|| = {max_gs:.1f}, "
          f"sigma = {sigma:.1f}")

    # 2. IMHK sampling (Klein proposals, Metropolis-corrected)
    sampler = lg.IMHKSampler(lat, sigma, device=device)
    points = sampler.sample(0, args.samples)
    print(f"sampled {tuple(points.shape)}, "
          f"acceptance = {sampler.acceptance_rate:.3f}")

    # 3. diagnostics
    _, log_ws = klein_sample_batch(sampler.pre, 2048, seed=1)
    gap = float(spectral_gap_mc(log_ws))
    print(f"spectral gap >= {gap:.4f}")
    ess = float(effective_sample_size(points[:, 0]))
    print(f"ESS(coordinate 0) = {ess:.0f} / {points.shape[0]}")

    # 4. moments sanity
    mean_abs = float(torch.mean(torch.abs(points)))
    std = float(torch.std(points, correction=0))
    print(f"mean |x| = {mean_abs:.2f}, std = {std:.2f} "
          f"(target ~{sigma:.1f})")
    return {"points": points, "acceptance": sampler.acceptance_rate,
            "spectral_gap": gap, "ess": ess, "std": std, "sigma": sigma,
            "finite": bool(np.isfinite(points.cpu().numpy()).all())}


if __name__ == "__main__":
    main()
