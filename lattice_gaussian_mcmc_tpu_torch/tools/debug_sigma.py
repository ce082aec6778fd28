"""Sigma-semantics check of the Klein draw (the port of the JAX package's
`scripts/debug_sigma.py`).

    python -m lattice_gaussian_mcmc_tpu_torch.tools.debug_sigma [n] [sigma]
        [--device cpu]

Checks, on Z^n and on a random unit-triangular basis, that
  - the empirical per-coordinate std of Klein draws matches the discrete
    Gaussian's std at the requested sigma (sigma_discrete <= sigma,
    converging as sigma grows),
  - the Klein validity threshold sigma >= max||b*_i|| / sqrt(2 ln n) is
    reported,
  - E||x|| tracks sigma_d sqrt(n): within 2% on Z^n, 5% on the triangular
    basis.
The draws are kernel B1 on the card (`klein_sample_batch_blocked`), its
plain version with `--device cpu`. Exits 0 on PASS, 1 on FAIL, 2 with no
card and no `--device cpu`.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    device_from_argv,
    resolve_device,
)


def discrete_gaussian_variance(sigma: float, tau: float = 12.0) -> float:
    """Var of D_{Z,sigma} by direct enumeration (== sigma^2 above smoothing,
    strictly below it for small sigma)."""
    r = int(math.ceil(tau * sigma)) + 1
    k = np.arange(-r, r + 1, dtype=np.float64)
    p = np.exp(-k * k / (2.0 * sigma * sigma))
    p /= p.sum()
    return float((p * k * k).sum())


def check(lat, sigma: float, seed: int, n_samples: int = 8192,
          label: str = "") -> float:
    """Print the lattice's sigma figures and the draws' moments; return
    |E||x|| - sigma_d sqrt(n)| / (sigma_d sqrt(n))."""
    from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
        smoothing_parameter,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        klein_precompute,
        klein_sample_batch_blocked,
    )
    n = lat.n
    eta = float(smoothing_parameter(lat))
    max_gs = float(torch.max(lat.gs_norms))
    klein_floor = max_gs / math.sqrt(2.0 * math.log(max(n, 2)))
    pre = klein_precompute(lat, sigma)
    X, _ = klein_sample_batch_blocked(pre, n_samples, seed=seed)
    pts = (X.to(torch.float64) @ lat.basis.T).cpu().numpy()
    d = np.linalg.norm(pts, axis=1)
    var_target = discrete_gaussian_variance(sigma)
    print(f"--- {label} (n={n}) ---")
    print(f"sigma={sigma:g}  eta={eta:.4g}  max||b*||={max_gs:.4g}  "
          f"klein_floor={klein_floor:.4g}  window={pre.window}")
    print(f"sigma/eta={sigma / eta:.3f}  "
          f"{'SMOOTH' if sigma > eta else 'BELOW smoothing'}; "
          f"sigma {'OK' if sigma >= klein_floor else 'BELOW'} Klein floor")
    exp_norm = math.sqrt(var_target * n)
    rel = abs(d.mean() - exp_norm) / exp_norm
    print(f"E||x||: empirical {d.mean():.4f} vs sigma_d*sqrt(n) "
          f"{exp_norm:.4f}  (rel err {rel:.3%})")
    emp_std = float(pts.std(axis=0).mean())
    print(f"per-coordinate std: empirical {emp_std:.4f} vs discrete-sigma "
          f"{math.sqrt(var_target):.4f} (continuous sigma {sigma:g})")
    return rel


def main(argv=None) -> int:
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
        smoothing_parameter,
    )
    from lattice_gaussian_mcmc_tpu_torch.lattices.identity import (
        identity_lattice,
    )
    args, device = device_from_argv(sys.argv[1:] if argv is None else argv)
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"debug_sigma: {e}", file=sys.stderr)
        return 2
    n = int(args[0]) if len(args) > 0 else 32
    lat = identity_lattice(n, device=device)
    sigma = float(args[1]) if len(args) > 1 else \
        2.0 * float(smoothing_parameter(lat))
    err1 = check(lat, sigma, seed=0, label="Z^n")

    rng = np.random.default_rng(0)
    B = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
    np.fill_diagonal(B, 1.0)
    lat2 = lattice_from_basis(B, name="random-triangular", device=device)
    sigma2 = 2.0 * float(smoothing_parameter(lat2))
    err2 = check(lat2, sigma2, seed=1, label="random triangular")

    ok = err1 < 0.02 and err2 < 0.05
    print(f"\nsanity: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
