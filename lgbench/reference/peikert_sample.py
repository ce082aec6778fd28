"""Plain reference of `PeikertSampler(lat, sigma).sample(seed, B)`: one
draw a chain of Peikert's convolution sampler (CRYPTO 2010), returned as
the lattice point B x.

Rounding width r = eta_eps(Z^n); Sigma2 = sigma^2 (B^T B)^-1 - r^2 I (plus
1e-10 I at the PSD edge) and its lower Cholesky factor L2, all float64 and
worked out here from the basis. A chain's normals z are the stream's
Box-Muller pairs of round 0; its centres c = -L2 z (target centre 0); each
coordinate is an independent windowed inverse-CDF draw of width r on the
row's uniform of round 0, with the window of the tail budget on the
constant profile r. The control forms L2 z from L2 and z rounded to TF32
with float32 sums, one precision below the float32 product the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from lgbench.reference import dgauss, lattice, stream

CHAINS = 1024


class Reference:
    def __init__(self, basis: np.ndarray, sigma: float, params: dict,
                 device):
        n = basis.shape[0]
        self.n = n
        self.r = lattice.smoothing_zn(n, float(params["eps"]))
        Sigma2 = (sigma ** 2 * np.linalg.inv(basis.T @ basis)
                  - self.r ** 2 * np.eye(n))
        L2 = np.linalg.cholesky(Sigma2 + 1e-10 * np.eye(n))
        self.window = lattice.window_budget(np.full(n, self.r),
                                            float(params["tail_budget"]))
        self.device = torch.device(device)
        self.L2 = torch.as_tensor(L2, device=self.device)
        self.basis = torch.as_tensor(basis, device=self.device)

    def shapes(self) -> dict:
        return {"n": self.n, "window": self.window}

    def expected(self, rows: dict, control: bool = False) -> torch.Tensor:
        seeds = rows["seed"].to(self.device)
        chains = rows["chain"].to(self.device)
        out = []
        for a in range(0, chains.shape[0], CHAINS):
            out.append(self._draws(seeds[a:a + CHAINS, None],
                                   chains[a:a + CHAINS, None], control))
        return torch.cat(out)

    def _draws(self, seeds, chains, control):
        n, dev = self.n, self.device
        pairs = torch.arange((n + 1) // 2, device=dev)[None, :]
        z0, z1 = stream.normals(seeds, chains, pairs, 0)
        z = torch.stack([z0, z1], dim=-1).reshape(seeds.shape[0], -1)[:, :n]
        if control:
            c = -(dgauss.tf32(z.to(torch.float32))
                  @ dgauss.tf32(self.L2.to(torch.float32)).T
                  ).to(torch.float64)
        else:
            c = -(z @ self.L2.T)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        u = stream.uniforms(seeds, chains,
                            torch.arange(n, device=dev)[None, :], zero)
        x, _ = dgauss.icdf(u, c, self.r, self.window)
        return x @ self.basis.T
