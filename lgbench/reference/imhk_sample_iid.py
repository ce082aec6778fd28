"""Plain reference of `IMHKSampler.sample_iid(seed, B, n_steps=S)`: each
chain starts from a Klein draw at stream step 0 and makes S independent
Metropolis-Hastings-Klein steps, step t proposing a Klein draw at stream
step t and accepting it when log u_t < log w(y) - log w(x); the result is
the final state's lattice point B x.

A Klein draw runs the rows i = n-1 .. 0 of the Gram-Schmidt factor
U = R / diag(R): centre c_i = -sum_{j>i} U_ij x_j (target centre 0),
width sigma / R_ii, the windowed inverse-CDF draw of `dgauss.icdf` on the
row's uniform, and log w = sum_i log Z_i. Everything is float64 and is
worked out here from the basis; the control makes the coupling
sum_{j>i} U_ij x_j with U rounded to TF32 and float32 sums, one precision
below the float32 coupling the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from lgbench.reference import dgauss, lattice, stream

ROWS = 64          # rows of uniforms made at a time
CHAINS = 128       # chains followed at a time


class Reference:
    def __init__(self, basis: np.ndarray, sigma: float, params: dict,
                 device):
        _, R = lattice.gso(basis)
        d = np.diag(R)
        self.n = basis.shape[0]
        self.steps = int(params["steps"])
        self.window = lattice.window_budget(sigma / d,
                                            float(params["tail_budget"]))
        self.device = torch.device(device)
        self.U = torch.as_tensor(R / d[:, None], device=self.device)
        self.sig = torch.as_tensor(sigma / d, device=self.device)
        self.basis = torch.as_tensor(basis, device=self.device)

    def shapes(self) -> dict:
        return {"n": self.n, "window": self.window, "steps": self.steps}

    def klein(self, seeds, chains, steps, control: bool):
        """Klein draws (coefficients (D, n), log w (D,)) of the counters
        (seeds, chains, steps), each (D,) int64."""
        n, D = self.n, chains.shape[0]
        X = torch.zeros(D, n, dtype=torch.float64, device=self.device)
        lw = torch.zeros(D, dtype=torch.float64, device=self.device)
        if control:
            U32 = dgauss.tf32(self.U.to(torch.float32))
            X32 = torch.zeros(D, n, dtype=torch.float32, device=self.device)
        for hi in range(n, 0, -ROWS):
            lo = max(0, hi - ROWS)
            rows = torch.arange(lo, hi, device=self.device)
            u = stream.uniforms(seeds[None, :], chains[None, :],
                                rows[:, None], steps[None, :])
            for i in range(hi - 1, lo - 1, -1):
                if control:
                    c = -(X32[:, i + 1:] @ U32[i, i + 1:]).to(torch.float64)
                else:
                    c = -(X[:, i + 1:] @ self.U[i, i + 1:])
                z, logz = dgauss.icdf(u[i - lo], c, self.sig[i], self.window)
                X[:, i] = z
                if control:
                    X32[:, i] = z.to(torch.float32)
                lw += logz
        return X, lw

    def expected(self, rows: dict, control: bool = False) -> torch.Tensor:
        """Lattice points (m, n) of the chains rows["chain"] of the calls
        whose seeds are rows["seed"]."""
        seeds = rows["seed"].to(self.device)
        chains = rows["chain"].to(self.device)
        out = []
        for a in range(0, chains.shape[0], CHAINS):
            out.append(self._chains(seeds[a:a + CHAINS],
                                    chains[a:a + CHAINS], control))
        return torch.cat(out)

    def _chains(self, seeds, chains, control):
        m, S = chains.shape[0], self.steps
        steps = torch.arange(S + 1, device=self.device)
        X, lw = self.klein(seeds.repeat(S + 1), chains.repeat(S + 1),
                           steps.repeat_interleave(m), control)
        X, lw = X.view(S + 1, m, self.n), lw.view(S + 1, m)
        x, w = X[0], lw[0]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in range(1, S + 1):
            u = stream.uniforms(seeds, chains, zero, zero + t,
                                stream.TAG_ACCEPT).clamp(min=1e-30)
            acc = torch.log(u) < lw[t] - w
            x = torch.where(acc[:, None], X[t], x)
            w = torch.where(acc, lw[t], w)
        return x @ self.basis.T
