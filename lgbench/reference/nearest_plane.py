"""Plain reference of `Lattice.nearest_plane(T)`: Babai's nearest plane in
float64 from the basis's own Gram-Schmidt factors,

    x_i = round((<q_i, t> - sum_{j>i} R_ij x_j) / R_ii),  i = n-1 .. 0,

rounding half to even; the result is the integer coefficient vector. The
control computes <q_i, t> in float32 and the recursion in U = R / diag(R)
rounded to TF32 with float32 sums, one precision below each stated one
(float64 centres, a float32 recursion).
"""

from __future__ import annotations

import numpy as np
import torch

from lgbench.reference import dgauss, lattice

TARGETS = 4096


class Reference:
    def __init__(self, basis: np.ndarray, sigma, params: dict, device):
        Q, R = lattice.gso(basis)
        self.n = basis.shape[0]
        self.device = torch.device(device)
        self.Q = torch.as_tensor(Q, device=self.device)
        self.R = torch.as_tensor(R, device=self.device)
        self.d = torch.diagonal(self.R).clone()

    def shapes(self) -> dict:
        return {"n": self.n}

    def expected(self, rows: dict, control: bool = False) -> torch.Tensor:
        t = rows["target"].to(self.device, torch.float64)
        return torch.cat([self._decode(t[a:a + TARGETS], control)
                          for a in range(0, t.shape[0], TARGETS)])

    def _decode(self, t, control):
        n = self.n
        x = torch.zeros(t.shape[0], n, dtype=torch.float64,
                        device=self.device)
        if control:
            ct = ((t.to(torch.float32) @ self.Q.to(torch.float32))
                  / self.d.to(torch.float32))
            U = dgauss.tf32((self.R / self.d[:, None]).to(torch.float32))
            x32 = x.to(torch.float32)
            for i in range(n - 1, -1, -1):
                x32[:, i] = torch.round(ct[:, i] - x32[:, i + 1:]
                                        @ U[i, i + 1:])
            return x32.to(torch.float64)
        cp = t @ self.Q
        for i in range(n - 1, -1, -1):
            x[:, i] = torch.round((cp[:, i] - x[:, i + 1:] @ self.R[i, i + 1:])
                                  / self.R[i, i])
        return x
