"""Z^n, the identity lattice: closed forms and the direct sampler
(counterpart of the JAX package's `lattices/identity.py`).

`sample_zn` draws the n coordinates independently. On a card, with a scalar
sigma and centre, it draws through kernel B8 (`ops/kernels/zn_cuda.py`):
the windowed inverse-CDF path below materialises a (num, window) tensor
(17 GB at the benchmark suite's 65,536 x 1024 draws), B8 one window per
block. Elsewhere it runs that inverse-CDF path on the same Philox uniforms.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
    sample_dgauss_inverse_cdf,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import zn_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
    jacobi_theta3,
    log_partition_zn,
    log_rho_Z,
    smoothing_parameter_zn,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.prng import draw_uniforms

__all__ = [
    "identity_lattice",
    "sample_zn",
    "decode_cvp_zn",
    "log_partition_zn",
    "smoothing_parameter_zn",
]


def identity_lattice(n: int, dtype=torch.float64, device=None) -> Lattice:
    """Z^n with basis = Q = R = I, on `device` (the card unless asked)."""
    device = resolve_device(device)
    eye = torch.eye(n, dtype=dtype, device=device)
    return Lattice(basis=eye, Q=eye.clone(), R=eye.clone(),
                   gs_norms=torch.ones(n, dtype=dtype, device=device),
                   name=f"Z^{n}", meta={"kind": "identity", "n": n})


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.ndim == 0


def sample_zn(seed: int, n: int, sigma, center=None, shape=(),
              window: int = DEFAULT_WINDOW, *, uniforms=None,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """Direct i.i.d. sampling of D_{Z^n, sigma, c}, shape `shape + (n,)`.
    Exact on the window: the coordinates are independent. The uniforms are
    the caller's (`uniforms`, shape `shape + (n,)`) or Philox draws of
    `utils/prng.py` `draw_uniforms` in flat order (four draws a Philox
    call, draw 4j + w on word w of counter j). On a card with a scalar
    sigma and centre: kernel B8; otherwise the inverse-CDF path."""
    device = uniforms.device if uniforms is not None else \
        resolve_device(device)
    shape = tuple(shape) + (n,)
    num = int(np.prod(shape))
    c = 0.0 if center is None else center
    if device.type == "cuda" and _is_scalar(sigma) and _is_scalar(c):
        u = uniforms.reshape(-1) if uniforms is not None else None
        return zn_cuda.sample_zn_draws(
            num, float(sigma), float(c), window, seed=seed, uniforms=u,
            device=device).reshape(shape).to(dtype)
    u = (uniforms if uniforms is not None
         else draw_uniforms(seed, num, device).reshape(shape))
    center = torch.as_tensor(c, dtype=dtype).to(device).expand(shape)
    sig = torch.as_tensor(sigma, dtype=dtype).to(device).expand(shape)
    return sample_dgauss_inverse_cdf(u.to(dtype), center, sig, window)


def decode_cvp_zn(target) -> torch.Tensor:
    """CVP in Z^n is coordinate-wise rounding."""
    return torch.round(torch.as_tensor(target))


def successive_minima_zn(n: int) -> np.ndarray:
    """lambda_i(Z^n) = 1 for all i."""
    return np.ones(n)


def kissing_number_zn(n: int) -> int:
    """The kissing number of Z^n: 2n (the +-e_i)."""
    return 2 * n


def theta_series_zn(q, n: int) -> torch.Tensor:
    """Theta_{Z^n}(q) = theta_3(0, q)^n."""
    return jacobi_theta3(0.0, q) ** n


def validate_identity_lattice(n: int = 8, sigma: float = 3.0,
                              n_samples: int = 50_000, seed: int = 0,
                              device=None) -> dict:
    """Self-check: moments of direct sampling and a finite partition
    function."""
    z = sample_zn(seed, n, sigma, shape=(n_samples,), device=device)
    za = z.double().cpu().numpy()
    checks = {
        "mean_ok": bool(abs(za.mean()) < 5 * sigma / np.sqrt(n_samples * n)),
        "std_ok": bool(abs(za.std() - sigma) / sigma < 0.02),
        "partition_consistent": bool(np.isfinite(
            float(n * log_rho_Z(torch.tensor(sigma, dtype=torch.float64))))),
    }
    checks["all_passed"] = all(checks.values())
    return checks
