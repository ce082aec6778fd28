"""Peikert's convolution sampler: the fully parallel lattice Gaussian
sampler (counterpart of the JAX package's `samplers/peikert.py`).

To draw x with B x ~ D_{Lambda, sigma, c} (Peikert, CRYPTO 2010):
  1. a rounding width r >= eta_eps(Z);
  2. a continuous perturbation p ~ N(0, Sigma2) with
     Sigma2 = sigma^2 (B^T B)^{-1} - r^2 I (PSD iff sigma >= r s1(B));
  3. independent roundings x_i ~ D_{Z, r, (c' - p)_i}, c' = B^{-1} c.
No step depends on another coordinate's draw; the price is
sigma >= r s1(B), where Klein needs only ~max ||b*_i||.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
    sample_dgauss,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    peikert_cuda,
    points_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import klein_points
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    check_backend,
    resolve_device,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_GUMBEL,
    chain_ids,
    philox_uniform,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PeikertPrecomp:
    """Fields:
      basis:  (n, n) basis.
      L2:     (n, n) lower Cholesky factor of Sigma2.
      cprime: (n,) B^{-1} c.
      r:      rounding width (0-d tensor).
      sigma:  target width (0-d tensor).
      window: window of the plain path's roundings.
    """

    basis: torch.Tensor
    L2: torch.Tensor
    cprime: torch.Tensor
    r: torch.Tensor
    sigma: torch.Tensor
    window: int = DEFAULT_WINDOW

    @property
    def n(self) -> int:
        return self.basis.shape[0]


def peikert_precompute(lattice: Lattice, sigma, center=None,
                       r: Optional[float] = None, eps: float = 0.01,
                       window: int = DEFAULT_WINDOW) -> PeikertPrecomp:
    """Host float64 inverse and Cholesky of Sigma2 = sigma^2 (B^T B)^{-1} -
    r^2 I (plus 1e-10 I of jitter at the PSD boundary), and the
    coefficient-space centre; tensors in the lattice's dtype and device.
    Below sigma = r s1(B) the Cholesky fails."""
    n = lattice.n
    dtype, dev = lattice.basis.dtype, lattice.basis.device
    if r is None:
        r = smoothing_parameter_zn(n, eps)
    Bh = lattice.basis.cpu().numpy().astype(np.float64)
    rh, sh = float(r), float(sigma)
    Ginv = np.linalg.inv(Bh.T @ Bh)
    Sigma2 = sh ** 2 * Ginv - rh ** 2 * np.eye(n)
    L2h = np.linalg.cholesky(Sigma2 + 1e-10 * np.eye(n))
    if center is None:
        cprime = np.zeros(n)
    else:
        cprime = np.linalg.solve(Bh, np.asarray(center, dtype=np.float64))

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    return PeikertPrecomp(basis=lattice.basis, L2=t(L2h), cprime=t(cprime),
                          r=t(rh), sigma=t(sh), window=int(window))


def peikert_precomp_from_numpy(d: Dict[str, np.ndarray], dtype=torch.float64,
                               device=None) -> PeikertPrecomp:
    """A `PeikertPrecomp` from the JAX object's fields as numpy arrays
    (`basis, L2, cprime, r, sigma, window`), so both packages sample from
    the same precomputation."""
    device = resolve_device(device)

    def t(k):
        return torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)

    return PeikertPrecomp(basis=t("basis"), L2=t("L2"), cprime=t("cprime"),
                          r=t("r"), sigma=t("sigma"),
                          window=int(d["window"]))


def peikert_sample_batch(pre: PeikertPrecomp, num_samples: int,
                         seed: int = 0, chain_offset: int = 0):
    """Plain batched draw, the JAX package's law: Box-Muller normals z
    (`peikert_cuda.philox_normals`, round 0), p = L2 z, and Gumbel-max
    roundings on pre.window around c' - p, uniforms of counter (chain,
    i W + k, 0, TAG_GUMBEL). Returns coeffs (B, n) in the precomputation's
    dtype."""
    n, dt, dev = pre.n, pre.L2.dtype, pre.L2.device
    n_even = n + n % 2
    chains = chain_ids(num_samples, chain_offset, dev)
    z = peikert_cuda.philox_normals(seed, chains, 0, n_even)[:n].to(dt)
    centers = pre.cprime[None, :] - (pre.L2 @ z).T              # (B, n)
    W = pre.window
    u = philox_uniform(seed, chains, 0, torch.arange(n * W, device=dev),
                       TAG_GUMBEL).to(dt)
    u = u.T.reshape(num_samples, n, W)
    return sample_dgauss(u, centers, pre.r, W)


def peikert_sample(pre: PeikertPrecomp, seed: int = 0, chain: int = 0):
    """One draw: chain `chain` of `peikert_sample_batch` at the same seed.
    Returns integer-valued coefficients (n,)."""
    return peikert_sample_batch(pre, 1, seed=seed, chain_offset=chain)[0]


class PeikertSampler:
    """Peikert's sampler on one lattice, with its validity check
    sigma >= r s1(B). `sample` draws through kernel B5 on a card and its
    plain version on the CPU, always with the window of
    `suggest_peikert_window(r, n)` (the JAX sampler's Pallas path has the
    same policy), so the sampler takes no window. Runs on `device` (the
    card unless asked)."""

    def __init__(self, lattice: Lattice, sigma: float, center=None,
                 r: Optional[float] = None, eps: float = 0.01, device=None):
        self.device = resolve_device(device)
        self.lattice = lattice
        self.sigma = float(sigma)
        with span("lgm.setup.precompute"):
            # checked before the Cholesky, which fails below the bound
            s1 = float(np.linalg.norm(lattice.basis.cpu().numpy(), ord=2))
            r_val = float(r) if r is not None else smoothing_parameter_zn(
                lattice.n, eps)
            if self.sigma < r_val * s1:
                raise ValueError(
                    f"Peikert requires sigma >= r * s1(B) = "
                    f"{r_val * s1:.4g}; got sigma={self.sigma:.4g}. Use "
                    "Klein/IMHK for small sigma.")
            self.s1 = s1
            self.pre = peikert_precompute(lattice, sigma, center, r_val, eps)
            self.pre = dataclasses.replace(
                self.pre, basis=self.pre.basis.to(self.device),
                L2=self.pre.L2.to(self.device),
                cprime=self.pre.cprime.to(self.device))
        self.limbs = points_cuda.points_operands(self.pre.basis)
        self._ops = None

    @property
    def operands(self) -> peikert_cuda.PeikertOperands:
        if self._ops is None:
            self._ops = peikert_cuda.peikert_operands(self.pre)
        return self._ops

    def sample(self, seed: int, num_samples: int = 1,
               return_coeffs: bool = False, backend: str = "auto"):
        """num_samples independent draws (one round of B5), as lattice
        points (num_samples, n) or coefficients. On a card the points come
        from the ring's float32 coefficients as they lie, through the int8
        kernel where the basis has limbs (`klein_points`). backend "cuda"
        raises unless the sampler is on a card."""
        with span("lgm.entry.peikert_sample"):
            check_backend(backend, self.device)
            ops = self.operands
            ring = peikert_cuda.peikert_rounds(ops, num_samples, 1,
                                               seed=seed)
            coeffs = peikert_cuda.ring_coeffs(ops, ring)[0]
            if return_coeffs:
                return coeffs
            return klein_points(self.pre.basis, coeffs, self.limbs)
