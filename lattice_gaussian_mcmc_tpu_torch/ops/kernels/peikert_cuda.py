"""Peikert's convolution sampler (B5) on Hopper: the wrapper of the CUDA
kernel in `csrc/peikert.cu`, its plain PyTorch version, the launch count,
the operand preparation and the window policy.

Replaces the Pallas kernel
`lattice_gaussian_mcmc_tpu/ops/kernels/peikert_pallas.py` `_peikert_kernel`
(`peikert_sample_batch_pallas`, `peikert_rounds_pallas`).

Per chain and round: standard normals z, centres c = c' - L2 z, then n
independent windowed inverse-CDF roundings of width r. n pads to a
multiple of 64 (padded rows: L2 rows and columns 0, c' = 0; they draw
values that are sliced off). The output is a ring (n_rounds * n_pad, B):
round k's chain-minor draws in rows k n_pad ...

Randomness. Either the caller passes both normals and uniforms, each
(n_rounds * n_pad, B) with row k n_pad + i = coordinate i of round k (the
Pallas wrapper's row layout, padded per round to n_pad), or the kernel
draws them from Philox: the uniform of row i in round k has counter
(chain id, i, k, TAG_ROW); the normals of rows 2p and 2p + 1 are the
Box-Muller pair of words 0 and 1 of counter (chain id, p, k, TAG_NORMAL).
The plain version computes the same normals with torch's log, sqrt, cos and
sin, which need not round as the card's do, so kernel and plain agree bit
for bit only on the caller's normals.

Dispatch. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    window_offsets,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    check_cuda,
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.klein_cuda import (
    ROW_BLOCK,
    _draw_row_plain,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    MAX_WINDOW,
    suggest_window_budget,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_NORMAL,
    TAG_ROW,
    chain_ids,
    mantissa_uniform,
    philox_uniform,
    philox_words,
    seed_key,
)

TWO_PI = 2.0 * math.pi


def suggest_peikert_window(r: float, n: int, budget: float = 0.01) -> int:
    """Window for n roundings of one width r: `suggest_window_budget` on
    the constant profile sigma_i = r."""
    return suggest_window_budget(np.full(n, float(r)), budget)


@dataclasses.dataclass
class PeikertOperands:
    """Kernel operands, in the working dtype.

      L2T: (n_pad, n_pad) the Cholesky factor L2 transposed, padded with 0.
      cp:  (n_pad,) coefficient-space centre c' (0 on padded rows).
      isg: 1 / r, a Python float.
      n:   the lattice dimension before padding.
      window: the rounding window.
    """

    L2T: torch.Tensor
    cp: torch.Tensor
    isg: float
    n: int
    window: int

    @property
    def n_pad(self) -> int:
        return self.L2T.shape[0]

    @property
    def device(self) -> torch.device:
        return self.L2T.device


def peikert_operands(pre, window: Optional[int] = None,
                     dtype=torch.float32) -> PeikertOperands:
    """Operands of a `PeikertPrecomp`; `window` defaults to
    `suggest_peikert_window(r, n)`."""
    n = pre.n
    n_pad = -(-n // ROW_BLOCK) * ROW_BLOCK
    r = float(pre.r)
    if window is None:
        window = suggest_peikert_window(r, n)
    dev = pre.L2.device
    L2T = torch.zeros(n_pad, n_pad, dtype=dtype, device=dev)
    L2T[:n, :n] = pre.L2.T.to(dtype)
    cp = torch.zeros(n_pad, dtype=dtype, device=dev)
    cp[:n] = pre.cprime.to(dtype)
    return PeikertOperands(L2T=L2T.contiguous(), cp=cp,
                           isg=float(np.float32(1.0 / r)), n=n,
                           window=int(window))


# ---------------------------------------------------------------------------
# Plain PyTorch version: the kernel's arithmetic, any device and dtype.
# ---------------------------------------------------------------------------


def philox_normals(seed: int, chains: torch.Tensor, rnd: int,
                   n_pad: int) -> torch.Tensor:
    """(n_pad, B) standard normals of round `rnd`: Box-Muller of words 0
    and 1 of counter (chain, p, rnd, TAG_NORMAL) into rows 2p, 2p + 1."""
    w = philox_words(seed, chains, rnd, torch.arange(
        n_pad // 2, device=chains.device), TAG_NORMAL)
    u1 = 1.0 - mantissa_uniform(w[0])
    u2 = mantissa_uniform(w[1])
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = u2 * float(np.float32(TWO_PI))
    z = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], dim=1)
    return z.reshape(n_pad, -1)


def peikert_rounds_plain(ops: PeikertOperands, num_chains: int,
                         n_rounds: int = 1, *, seed: int = 0,
                         chain_offset: int = 0, uniforms=None, normals=None):
    """Plain version of B5: returns the ring (n_rounds * n_pad, B)."""
    n_pad, dt, dev = ops.n_pad, ops.L2T.dtype, ops.device
    if (uniforms is None) != (normals is None):
        raise ValueError("pass both host uniforms and normals, or neither")
    offs = window_offsets(ops.window, dt, dev)[:, None, None]
    offs_half = 0.5 * offs * offs
    isg = torch.tensor(ops.isg, dtype=dt, device=dev)
    chains = chain_ids(num_chains, chain_offset, dev)
    ring = torch.empty(n_rounds * n_pad, num_chains, dtype=dt, device=dev)
    for k in range(n_rounds):
        rows = slice(k * n_pad, (k + 1) * n_pad)
        if normals is not None:
            z, u = normals[rows].to(dt), uniforms[rows].to(dt)
        else:
            z = philox_normals(seed, chains, k, n_pad).to(dt)
            u = philox_uniform(seed, chains, k, torch.arange(n_pad,
                                                             device=dev),
                               TAG_ROW).to(dt)
        c = ops.cp[:, None] - ops.L2T.T @ z
        ring[rows], _ = _draw_row_plain(c, isg, u, ops.window, offs,
                                        offs_half)
    return ring


def ring_coeffs(ops: PeikertOperands, ring: torch.Tensor) -> torch.Tensor:
    """Ring (n_rounds * n_pad, B) -> (n_rounds, B, n) coefficients."""
    n_rounds = ring.shape[0] // ops.n_pad
    return ring.reshape(n_rounds, ops.n_pad, -1)[:, :ops.n].transpose(1, 2)


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------


def peikert_rounds(ops: PeikertOperands, num_chains: int,
                   n_rounds: int = 1, *, seed: int = 0,
                   chain_offset: int = 0, uniforms=None, normals=None):
    """B5: n_rounds independent Peikert draws per chain in one launch.
    Returns the ring (n_rounds * n_pad, B). CPU operands run
    `peikert_rounds_plain`."""
    if ops.device.type == "cpu":
        return peikert_rounds_plain(ops, num_chains, n_rounds, seed=seed,
                                    chain_offset=chain_offset,
                                    uniforms=uniforms, normals=normals)
    n_pad = ops.n_pad
    if n_pad % ROW_BLOCK:
        raise ValueError(f"n_pad {n_pad} is not a multiple of {ROW_BLOCK}")
    check_cuda("L2T", ops.L2T, (n_pad, n_pad))
    check_cuda("cp", ops.cp, (n_pad,))
    if not 1 <= ops.window <= MAX_WINDOW:
        raise ValueError(f"window {ops.window} outside [1, {MAX_WINDOW}]")
    if n_rounds < 1:
        raise ValueError(f"n_rounds {n_rounds} must be >= 1")
    if (uniforms is None) != (normals is None):
        raise ValueError("pass both host uniforms and normals, or neither")
    if uniforms is not None:
        check_cuda("uniforms", uniforms, (n_rounds * n_pad, num_chains))
        check_cuda("normals", normals, (n_rounds * n_pad, num_chains))
        z = None
    else:
        z = torch.empty(n_pad, num_chains, dtype=torch.float32,
                        device=ops.device)
    lib = load("peikert")
    ring = torch.empty(n_rounds * n_pad, num_chains, dtype=torch.float32,
                       device=ops.device)
    k0, k1 = seed_key(seed)
    rc = lib.peikert_rounds_launch(
        ptr(ops.L2T), ptr(ops.cp), ops.isg,
        ptr(uniforms) if uniforms is not None else None,
        ptr(normals) if normals is not None else None,
        ptr(z) if z is not None else None, ptr(ring), n_pad, num_chains,
        ops.window, n_rounds, k0, k1, chain_offset,
        ctypes.c_void_p(torch.cuda.current_stream(ops.device).cuda_stream))
    raise_on("peikert", rc, "peikert_rounds")
    peikert_rounds.launches += 1
    return ring


def reset_launch_counts():
    peikert_rounds.launches = 0


reset_launch_counts()
