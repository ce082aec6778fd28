"""`FalconSigner(lat, sigma, q, beta2, tail_budget)`: a call hashes
`chains` messages to their targets from the call's seed
(`hash_to_point`), then signs them (`sign`: centred B1 at each message's
own centre, the float64 products to s, the norm bound and the redraws),
returned as the signatures s = (s1, s2), float64 integer-valued.

The configuration's guarantee that every returned s meets ||s||^2 <=
floor(beta^2) is held on every row of every call, not on the rows the
harness samples: a call that returns a row above it raises, and the
harness counts it as failed."""

from __future__ import annotations

import torch

from lattice_gaussian_mcmc_tpu_torch import FalconSigner, lattice_from_basis


class Entry:
    def __init__(self, plan):
        mix = plan.mix
        self.messages = int(mix["chains"])
        self.beta2 = int(mix["beta2"])
        lat = lattice_from_basis(plan.basis, device=plan.device)
        self.signer = FalconSigner(lat, plan.sigma, int(mix["q"]),
                                   self.beta2,
                                   tail_budget=float(mix["tail_budget"]),
                                   device=plan.device)

    def call(self, args):
        c = self.signer.hash_to_point(args["seed"], self.messages)
        s = self.signer.sign(args["seed"], c)
        # one read of s; ||s||^2 is an integer below 2^53, so the rounded
        # square of its float64 root is it exactly
        norms = torch.linalg.vector_norm(s, dim=1).square_().round_()
        over = int((norms > self.beta2).sum())
        if over:
            raise RuntimeError(f"{over} of {s.shape[0]} signatures have "
                               f"||s||^2 above {self.beta2}")
        return s
