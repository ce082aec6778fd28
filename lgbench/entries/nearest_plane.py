"""`Lattice.nearest_plane(T)`: Babai's nearest plane of a batch of
targets (B7 on the card after the float64 centre products), returned as
float64 integer coefficients."""

from __future__ import annotations

from lattice_gaussian_mcmc_tpu_torch import lattice_from_basis


class Entry:
    def __init__(self, plan):
        self.lattice = lattice_from_basis(plan.basis, device=plan.device)

    def call(self, args):
        return self.lattice.nearest_plane(args["targets"])
