"""One sampler facade that picks the algorithm by lattice kind
(counterpart of the JAX package's `samplers/unified.py`):

  identity   -> direct i.i.d. per-coordinate sampling (`sample_zn`, B8)
  qary/ntru  -> Klein (B1), or IMHK with `exact=True` (B1, B2, B3)
  generic    -> Klein / IMHK
  any        -> "smk" (B1, B4) or "peikert" (B5) on request

plus CVP decoding: Babai (B7) or annealed Gibbs from the Babai point.
"""

from __future__ import annotations

from typing import Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import (
    Lattice,
    smoothing_parameter,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import sample_zn
from lattice_gaussian_mcmc_tpu_torch.samplers.gibbs import (
    annealed_gibbs_decode,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (
    IMHKSampler,
    MetropolisKleinSampler,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import KleinSampler
from lattice_gaussian_mcmc_tpu_torch.samplers.peikert import PeikertSampler
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device

ALGORITHMS = ("direct", "klein", "imhk", "smk", "peikert")


class UnifiedLatticeSampler:
    """Dispatch by `lattice.meta["kind"]` and `algorithm`. Runs on `device`
    (the card unless asked)."""

    def __init__(self, lattice: Lattice, sigma: Optional[float] = None,
                 exact: bool = False, window: Optional[int] = None,
                 algorithm: Optional[str] = None,
                 proposal_sigma: Optional[float] = None, device=None):
        """`exact=True` uses IMHK (MH-corrected), otherwise plain Klein.
        `algorithm` overrides the dispatch: one of "direct" (Z^n only),
        "klein", "imhk", "smk" (`proposal_sigma` sets its move width) or
        "peikert" (raises below sigma = r s1(B)). sigma defaults to 1.5 x the
        smoothing-parameter bound."""
        self.device = resolve_device(device)
        self.lattice = lattice
        self.kind = lattice.meta.get("kind", "generic")
        if sigma is None:
            sigma = 1.5 * float(smoothing_parameter(lattice))
        self.sigma = float(sigma)
        self.exact = exact
        if algorithm is None:
            algorithm = ("direct" if self.kind == "identity"
                         else ("imhk" if exact else "klein"))
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if algorithm == "direct" and self.kind != "identity":
            raise ValueError("direct sampling is exact only on Z^n")
        self._algorithm = algorithm
        dev = self.device
        if algorithm == "direct":
            self._impl = None
        elif algorithm == "imhk":
            self._impl = IMHKSampler(lattice, self.sigma, window=window,
                                     device=dev)
        elif algorithm == "smk":
            self._impl = MetropolisKleinSampler(
                lattice, self.sigma, proposal_sigma=proposal_sigma,
                window=window, device=dev)
        elif algorithm == "peikert":
            self._impl = PeikertSampler(lattice, self.sigma, device=dev)
        else:
            self._impl = KleinSampler(lattice, self.sigma, window=window,
                                      device=dev)

    @property
    def algorithm(self) -> str:
        return self._algorithm

    def sample(self, seed: int, num_samples: int, **kw):
        """(num_samples, n) lattice points (keyword arguments go to the
        chosen sampler's `sample`)."""
        if self._algorithm == "direct":
            return sample_zn(seed, self.lattice.n, self.sigma,
                             shape=(num_samples,), device=self.device,
                             dtype=self.lattice.basis.dtype)
        return self._impl.sample(seed, num_samples, **kw)

    def decode(self, seed: int, target, stochastic: bool = True,
               n_chains: int = 64, n_sweeps: int = 50):
        """CVP decoding of one target (n,) or a batch (T, n): Babai (kernel
        B7), refined by annealed Gibbs from sigma0 = self.sigma when
        `stochastic`. Returns (point(s), coefficients)."""
        target = torch.as_tensor(target).to(device=self.lattice.basis.device,
                                            dtype=self.lattice.basis.dtype)
        if not stochastic:
            return self.lattice.decode_cvp(target)
        point, coeffs, _ = annealed_gibbs_decode(
            seed, self.lattice, target, sigma0=self.sigma,
            n_sweeps=n_sweeps, n_chains=n_chains)
        return point, coeffs

    def short_vector(self, seed: int, n_samples: int = 4096):
        """The shortest nonzero sampled vector."""
        pts = self.sample(seed, n_samples)
        norms = torch.linalg.norm(pts.to(torch.float64), dim=1)
        norms = torch.where(norms < 1e-9, torch.inf, norms)
        return pts[torch.argmin(norms)]
