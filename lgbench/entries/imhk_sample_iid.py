"""`IMHKSampler(lat, sigma, tail_budget).sample_iid(seed, chains,
n_steps=steps)`: a Klein start (B1) and `steps` fused IMHK steps (B2) a
chain, returned as lattice points, the default."""

from __future__ import annotations

from lattice_gaussian_mcmc_tpu_torch import IMHKSampler, lattice_from_basis


class Entry:
    def __init__(self, plan):
        self.chains = int(plan.mix["chains"])
        self.steps = int(plan.mix["steps"])
        lat = lattice_from_basis(plan.basis, device=plan.device)
        self.sampler = IMHKSampler(lat, plan.sigma,
                                   tail_budget=float(plan.mix["tail_budget"]),
                                   device=plan.device)

    def call(self, args):
        return self.sampler.sample_iid(args["seed"], self.chains,
                                       n_steps=self.steps)
