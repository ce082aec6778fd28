"""NTRU / FALCON-style sampling: keygen, secret-basis Klein, CVP decoding
(the port of the JAX package's `examples/ntru_falcon.py`).

    python -m lattice_gaussian_mcmc_tpu_torch.examples.ntru_falcon [--cpu]
        [--n 64]

Runs on the CUDA card (Klein draws through kernel B1, Babai through B7)
unless `--cpu` is given, where their plain versions run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=64, help="ring degree")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    import lattice_gaussian_mcmc_tpu_torch as lg
    from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import (
        ntru_keygen,
        verify_ntru_basis,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.unified import (
        UnifiedLatticeSampler,
    )

    # 1. exact host keygen: f, g, F, G with f G - g F = q
    key = ntru_keygen(args.n, q=12289, seed=7)
    checks = verify_ntru_basis(key)
    print("keygen checks:", checks)

    # 2. lattice + sampler on the short secret basis
    lat = lg.ntru_lattice(args.n, q=12289, seed=7, key=key, device=device)
    sigma = 1.2 * float(torch.max(lat.gs_norms))
    s = UnifiedLatticeSampler(lat, sigma, device=device)
    pts = s.sample(0, 4096)
    mean_norm = float(torch.mean(torch.linalg.norm(pts, dim=1)))
    print(f"dim {lat.n}: sampled {tuple(pts.shape)}, mean norm = "
          f"{mean_norm:.1f} (expect ~{sigma * np.sqrt(lat.n):.1f})")

    # 3. CVP decoding (MIMO-style): Babai vs annealed Gibbs
    rng = np.random.default_rng(1)
    target = torch.as_tensor(rng.normal(scale=50.0, size=lat.n))
    babai_pt, _ = s.decode(2, target, stochastic=False)
    gibbs_pt, _ = s.decode(2, target, stochastic=True, n_sweeps=30,
                           n_chains=32)
    t = target.to(babai_pt)
    d_b = float(torch.linalg.norm(babai_pt - t))
    d_g = float(torch.linalg.norm(gibbs_pt - t))
    print(f"CVP distance: Babai {d_b:.2f} vs annealed Gibbs {d_g:.2f}")
    return {"keygen_checks": checks, "dim": lat.n, "sigma": sigma,
            "mean_norm": mean_norm, "babai_distance": d_b,
            "gibbs_distance": d_g}


if __name__ == "__main__":
    main()
