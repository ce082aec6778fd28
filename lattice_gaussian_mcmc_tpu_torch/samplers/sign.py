"""FALCON-style signing on an NTRU secret basis: Sign of the Falcon spec
v1.2 (Algorithm 10) with Klein's sampler in place of ffSampling, batched
over messages on one card. Klein's law is D_{Lambda, sigma, t}; each
coordinate's draw inverts its window's CDF at a uniform of 23 bits, so a
point's probability is resolved to 2^-23 and points beyond ~5.3 of the
coordinate's widths (cumulative mass below 2^-24) are not drawn, however
wide the window.

The lattice is the port's NTRU convention (`lattices/ntru.py`): columns of
B = [[Rot(f), Rot(F)], [Rot(g), Rot(G)]] span {(u, v) : v = u h mod q},
h = g / f. For a message's target c in Z_q^n (`hash_to_point`) the signer
draws v ~ D_{Lambda, sigma, t} around t = (0, c) and returns s = t - v,
which satisfies s2 - h s1 = c mod q (`verify`), if ||s||^2 <= floor(beta^2);
otherwise it draws again.

Stream (the port's Philox, `utils/prng.py`, keyed by the call's seed):
- hash-to-point: coefficient j of message m is output word j mod 4 of
  counter (m, j div 4, 0, TAG_HASH), reduced mod q (`ops/kernels/
  sign_cuda.py`);
- attempt a of message m is the Klein draw of chain m at Philox step a:
  coordinate i takes the midpoint uniform (k + 1/2) 2^-23 of counter
  (m, i, a, TAG_ROW) (`utils/prng.py` `philox_midpoint`). A message
  whose ||s||^2 exceeds floor(beta^2) is drawn again at the same centre,
  attempt a + 1, until it passes; the others keep their first draw.

A call (`sign`): x_t = B^-1 t in float64, x0 = round(x_t), and centred B1
(`klein_cuda.klein_draw_centred`) draws y around the residual centres
U (x_t - x0), x = x0 + y. On the same uniforms this is the Klein draw at t
itself, since the window follows round(centre); and y's mean, x_t - x0,
lies within 1/2 of 0 in every coordinate, so y stays small however far t
lies (the bf16 coupling's exact 256, hazard C8). Then v = B x (exact: the
int8 tensor cores on the card, `points_cuda`, the float64 product on the
CPU), s = t - v in float64, ||s||^2 in int64, one host read of
the messages that fail the bound, and a redraw round on those alone (the
uniforms of their counters made by one launch, `sign_cuda.redraw_uniforms`,
and handed to the same kernel) until none is left. CPU tensors run the
kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import _negacyclic_rot
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    points_cuda,
    sign_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    ExactGuard,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    klein_points,
    klein_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

# the signer's tail budget: the spec's bound of 2^64 signing queries
SIGNING_TAIL_BUDGET = 2.0 ** -64


class FalconSigner:
    """Signs hashed messages with an NTRU secret basis of dimension 2n:
    `hash_to_point(seed, M)` makes the targets c (M, n), `sign(seed, c)`
    returns the signatures s = (s1, s2) (M, 2n), float64 integer-valued,
    each with ||s||^2 <= beta2. The window is the smallest whose truncated
    tail stays under `tail_budget` over the conditional widths. On the card
    the kernels run; with `device="cpu"` their plain versions."""

    def __init__(self, lattice: Lattice, sigma: float, q: int, beta2: int,
                 tail_budget: float = SIGNING_TAIL_BUDGET, device=None):
        self.device = resolve_device(device)
        dim = lattice.n
        if dim % 2:
            raise ValueError(f"an NTRU basis has even dimension, got {dim}")
        self.ring = dim // 2
        self.sigma, self.q, self.beta2 = float(sigma), int(q), int(beta2)
        self.pre = klein_precompute(lattice, sigma,
                                    tail_budget=tail_budget).to(self.device)
        with span("lgm.setup.precompute"):
            R = lattice.R.to(self.device, torch.float64)
            Q = lattice.Q.to(self.device, torch.float64)
            # x_t = B^-1 t = R^-1 Q^T t; t = (0, c) meets only the last n
            # columns of Q^T
            binv = torch.linalg.solve_triangular(R, Q.T, upper=True)
            self._binv_c = binv[:, self.ring:].contiguous()
            self._U = self.pre.U.to(torch.float64)
            self._basis = self.pre.basis.to(torch.float64)
        self._limbs = points_cuda.points_operands(self._basis)
        self._ops = None
        self.redraw_rounds = 0

    @property
    def operands(self) -> klein_cuda.KleinOperands:
        """Centred B1's operands (float32, centre 0: the centres come with
        each call)."""
        if self._ops is None:
            self._ops = klein_cuda.kernel_operands(self.pre)
        return self._ops

    @property
    def window(self) -> int:
        return self.pre.window

    def hash_to_point(self, seed: int, num_messages: int) -> torch.Tensor:
        """The targets c (num_messages, n) int64, uniform on Z_q^n, of
        messages 0 .. num_messages - 1 under `seed` (module docstring)."""
        with span("lgm.sign.hash"):
            return sign_cuda.hash_to_point(seed, num_messages, self.ring,
                                           self.q, self.device)

    def sign(self, seed: int, targets) -> torch.Tensor:
        """Signatures s = t - v (M, 2n) float64 of the targets c (M, n),
        t = (0, c), in message order, every one within the bound; draws on
        `seed`'s stream (module docstring). `redraw_rounds` records the
        rounds this call redrew."""
        with span("lgm.entry.sign"):
            ops = self.operands
            n_pad = ops.n_pad
            c = torch.as_tensor(targets).to(self.device, torch.float64)
            guard = ExactGuard(self.device)
            x0, cs = self.centres(c)
            y, _ = klein_cuda.klein_draw_centred(ops, cs, seed=seed, step=0,
                                                 guard=guard)
            s, bad = self._signatures(c, x0, y)
            rounds = 0
            while True:
                with span("lgm.sync.redraw"):
                    idx = torch.nonzero(bad).squeeze(1)
                if idx.numel() == 0:
                    break
                rounds += 1
                with span("lgm.sign.redraw"):
                    u = sign_cuda.redraw_uniforms(seed, idx, rounds, n_pad)
                    y, _ = klein_cuda.klein_draw_centred(
                        ops, cs[:, idx].contiguous(), uniforms=u, guard=guard)
                    s_r, bad_r = self._signatures(c[idx], x0[:, idx], y)
                    s[idx] = s_r
                    bad = torch.zeros_like(bad)
                    bad[idx] = bad_r
            guard.check("FalconSigner.sign")
            self.redraw_rounds = rounds
            return s

    def centres(self, c):
        """The integer points x0 = round(B^-1 t) (2n, M) float64 of the
        targets c (M, n) float64, t = (0, c), and centred B1's residual
        centres U (B^-1 t - x0) (n_pad, M) float32, padded rows 0."""
        ops = self.operands
        with span("lgm.layout.centres"):
            xt = self._binv_c @ c.T                      # (2n, M): B^-1 t
        with span("lgm.layout.recentre"):
            x0 = torch.round(xt)
            res = self._U @ xt.sub_(x0)
            cs = torch.zeros(ops.n_pad, c.shape[0], dtype=torch.float32,
                             device=self.device)
            cs[:ops.n] = res
        return x0, cs

    def _signatures(self, c, x0, y):
        """s = t - B x (M, 2n) and whether ||s||^2 passes the bound, for
        the coefficients x = x0 + y (x0 (2n, M) float64, y the draw)."""
        with span("lgm.layout.coeffs"):
            x = x0 + y[:x0.shape[0]]
        v = klein_points(self._basis, x.T, self._limbs)
        with span("lgm.sign.norms"):
            s = v.neg_()
            s[:, self.ring:] += c
            norms = torch.linalg.vecdot(s, s).to(torch.int64)
            return s, norms > self.beta2


def verify(h, c, s, q: int, beta2: int) -> torch.Tensor:
    """Which signatures s (M, 2n) verify for the public key h (n,) and the
    targets c (M, n): s2 - h s1 = c mod (q, x^n + 1) and ||s||^2 <= beta2.
    The products run in float64, exact for |s| h n < 2^53."""
    s = torch.as_tensor(s).to(torch.float64)
    n = s.shape[1] // 2
    h = h.cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
    rot = torch.as_tensor(_negacyclic_rot(h), dtype=torch.float64,
                          device=s.device)
    s1, s2 = s[:, :n], s[:, n:]
    lhs = torch.remainder(s2 - s1 @ rot.T, q).to(torch.int64)
    c = torch.as_tensor(c).to(s.device, torch.int64)
    norms = torch.linalg.vecdot(s, s).to(torch.int64)
    return (lhs == torch.remainder(c, q)).all(dim=1) & (norms <= beta2)
