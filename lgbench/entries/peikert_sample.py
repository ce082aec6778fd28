"""`PeikertSampler(lat, sigma).sample(seed, chains)`: one round of B5 a
call, the ring's coefficients, then the float64 product to lattice
points."""

from __future__ import annotations

from lattice_gaussian_mcmc_tpu_torch import PeikertSampler, lattice_from_basis


class Entry:
    def __init__(self, plan):
        self.chains = int(plan.mix["chains"])
        lat = lattice_from_basis(plan.basis, device=plan.device)
        self.sampler = PeikertSampler(lat, plan.sigma,
                                      eps=float(plan.mix["eps"]),
                                      device=plan.device)

    def call(self, args):
        return self.sampler.sample(args["seed"], self.chains)
