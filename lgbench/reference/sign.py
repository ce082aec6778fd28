"""Plain reference of `FalconSigner(lat, sigma, q, beta2, tail_budget)`'s
`sign(seed, hash_to_point(seed, M))`: FALCON's Sign (Falcon spec v1.2,
Algorithm 10) with a Klein draw, for message m of the call whose seed is s:

1. its target c in Z_q^n: coefficient j is output word j mod 4 of Philox
   counter (m, j div 4, 0, TAG_HASH) under s, reduced mod q;
2. t = (0, c) and its centre cs = (t Q) / diag(R), from the basis's own
   Gram-Schmidt factors;
3. attempt a = 0, 1, ..: the Klein draw at centre t on the midpoint
   uniforms (k + 1/2) 2^-23 of counters (m, row i, a, TAG_ROW), k the
   23-bit draw of `stream.uniforms` (k 2^-23), so that no uniform is 0:
   for i = 2n-1 .. 0,
   c_i = cs_i - sum_{j>i} U_ij x_j, x_i the windowed inverse-CDF draw of
   `dgauss.icdf` of width sigma / R_ii; s = t - B x, until
   ||s||^2 <= beta2 (the mix's "beta2", floor(beta^2)).

The result is s. Everything is float64 and is worked out here from the
basis and the mix (q, beta2 and the tail budget that sets the window). The
control computes cs from t and Q in float32 and the coupling with U rounded
to TF32 and float32 sums, one precision below each stated one (float64
centres, a float32 coupling).
"""

from __future__ import annotations

import numpy as np
import torch

from lgbench.reference import dgauss, lattice, stream

# the stream's tag of the hash-to-point, beside stream.TAG_ROW
TAG_HASH = 6
ROWS = 64          # rows of uniforms made at a time
MIDPOINT = 2.0 ** -24   # half a step of the 23-bit uniform
CHAINS = 1024      # messages followed at a time


class Reference:
    def __init__(self, basis: np.ndarray, sigma: float, params: dict,
                 device):
        Q, R = lattice.gso(basis)
        d = np.diag(R).copy()
        self.n = basis.shape[0]
        self.ring = self.n // 2
        self.q = int(params["q"])
        self.beta2 = int(params["beta2"])
        self.window = lattice.window_budget(sigma / d,
                                            float(params["tail_budget"]))
        self.device = torch.device(device)
        self.Q = torch.as_tensor(Q, device=self.device)
        self.d = torch.as_tensor(d, device=self.device)
        self.U = torch.as_tensor(R / d[:, None], device=self.device)
        self.sig = torch.as_tensor(sigma / d, device=self.device)
        self.basis = torch.as_tensor(basis, device=self.device)

    def shapes(self) -> dict:
        return {"n": self.n, "window": self.window}

    def hashes(self, seeds, messages) -> torch.Tensor:
        """The targets c (D, n) float64 of the messages under their seeds,
        each (D,) int64."""
        groups = -(-self.ring // 4)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        words = stream.words(seeds[:, None], messages[:, None],
                             torch.arange(groups, device=self.device)[None],
                             zero, TAG_HASH)
        c = torch.stack(words, dim=-1).reshape(seeds.shape[0], -1)
        return (c[:, :self.ring] % self.q).to(torch.float64)

    def klein(self, seeds, chains, step: int, cs, control: bool):
        """Klein draws (D, n) around the centres cs (D, n) on the counters
        (seeds, chains, row, step)."""
        n, D = self.n, chains.shape[0]
        X = torch.zeros(D, n, dtype=torch.float64, device=self.device)
        steps = torch.full((), step, dtype=torch.int64, device=self.device)
        if control:
            U32 = dgauss.tf32(self.U.to(torch.float32))
            X32 = torch.zeros(D, n, dtype=torch.float32, device=self.device)
        for hi in range(n, 0, -ROWS):
            lo = max(0, hi - ROWS)
            rows = torch.arange(lo, hi, device=self.device)
            u = stream.uniforms(seeds[None, :], chains[None, :],
                                rows[:, None], steps) + MIDPOINT
            for i in range(hi - 1, lo - 1, -1):
                if control:
                    c = cs[:, i] - (X32[:, i + 1:] @ U32[i, i + 1:]).to(
                        torch.float64)
                else:
                    c = cs[:, i] - X[:, i + 1:] @ self.U[i, i + 1:]
                z, _ = dgauss.icdf(u[i - lo], c, self.sig[i], self.window)
                X[:, i] = z
                if control:
                    X32[:, i] = z.to(torch.float32)
        return X

    def expected(self, rows: dict, control: bool = False) -> torch.Tensor:
        """Signatures (m, n) of the messages rows["chain"] of the calls
        whose seeds are rows["seed"]."""
        seeds = rows["seed"].to(self.device)
        msgs = rows["chain"].to(self.device)
        return torch.cat([self.sign(seeds[a:a + CHAINS],
                                    msgs[a:a + CHAINS], control)
                          for a in range(0, msgs.shape[0], CHAINS)])

    def sign(self, seeds, msgs, control: bool = False):
        """s (D, n) of the messages msgs (D,) under seeds (D,), each after
        the redraws it took."""
        c = self.hashes(seeds, msgs)
        t = torch.cat([torch.zeros_like(c), c], dim=1)
        if control:
            cs = ((t.to(torch.float32) @ self.Q.to(torch.float32))
                  / self.d.to(torch.float32)).to(torch.float64)
        else:
            cs = (t @ self.Q) / self.d
        s = torch.empty_like(t)
        pending = torch.arange(t.shape[0], device=self.device)
        attempt = 0
        while pending.numel():
            X = self.klein(seeds[pending], msgs[pending], attempt,
                           cs[pending], control)
            sp = t[pending] - X @ self.basis.T
            ok = (sp * sp).sum(dim=1) <= self.beta2
            s[pending[ok]] = sp[ok]
            pending = pending[~ok]
            attempt += 1
        return s
