"""The one traffic generator: it reads a mix file's parameters and makes the
calls of a run from its seed, before the window opens.

Kinds of mix (the file's "kind"):

- "seeded": each call draws fresh randomness from its own seed,
  run seed * "seed_stride" + k; call 0 is the warm-up, calls 1, 2, .. go
  into the window. A checked row is (call seed, chain id = row index).
- "targets": a pool of batches of decoding targets t = B x* + w, x*
  uniform on the integers of "coeff_range", w ~ N(0, (rho min ||b*_i||)^2)
  per coordinate with one rho a batch ("noise"), made on the device by a
  generator seeded with the run seed; call k takes batch k mod len(pool),
  the warm-up batch 0. A checked row is the target itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from lgbench.reference import lattice


@dataclasses.dataclass
class Call:
    args: dict                                  # what the entry is called on
    rows: Callable[[torch.Tensor], dict]        # row indices -> reference rows


class Seeded:
    def __init__(self, mix: dict, seed: int):
        self.stride = int(mix["seed_stride"])
        self.seed = int(seed)

    def call(self, k: int) -> Call:
        s = self.seed * self.stride + k
        return Call({"seed": s}, lambda idx: {
            "seed": torch.full(idx.shape, s, dtype=torch.int64),
            "chain": idx.to(torch.int64).cpu()})

    def close(self):
        pass


class Targets:
    def __init__(self, mix: dict, basis: np.ndarray, seed: int, device):
        _, R = lattice.gso(basis)
        scale = float(np.min(np.diag(R)))
        lo, hi = mix["coeff_range"]
        B = torch.as_tensor(basis, device=device)
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        n, size = basis.shape[0], int(mix["batch"])
        self.pool = []
        for rho in mix["noise"]:
            x = torch.randint(int(lo), int(hi) + 1, (size, n), generator=g,
                              device=device, dtype=torch.float64)
            w = torch.randn(size, n, generator=g, device=device,
                            dtype=torch.float64)
            self.pool.append(x @ B.T + (float(rho) * scale) * w)

    def call(self, k: int) -> Call:
        t = self.pool[k % len(self.pool)]
        return Call({"targets": t}, lambda idx: {
            "target": t.index_select(0, idx.to(t.device)).cpu()})

    def close(self):
        self.pool.clear()


def make(mix: dict, basis: np.ndarray, seed: int, device):
    if mix["kind"] == "seeded":
        return Seeded(mix, seed)
    if mix["kind"] == "targets":
        return Targets(mix, basis, seed, device)
    raise ValueError(f"unknown kind of mix {mix['kind']!r}")
