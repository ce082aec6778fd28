"""Peikert's convolution sampler (B5) on Hopper: the wrapper of the CUDA
kernel in `csrc/peikert_tc.cu`, its plain PyTorch version, the operand
preparation and the window policy.

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

The kernel forms L2 z on the tensor cores in 3xTF32: both operands split
in registers, x = hi + lo with hi = x truncated to TF32 and lo = x - hi
(`split_tf32` is the same split on the host; the kernel truncates lo to
TF32 too), and L2 z = hi.hi + hi.lo + lo.hi (hazard C9: the Pallas
kernel's two-part bf16 split is ~10 times less accurate). L2 goes to the
kernel packed in mma.sync m16n8k8 A-fragment order (`peikert_fragments`).
The kernel keeps a block's normals in shared memory: 32 chains a block up
to n_pad 1,792, 16 above (`peikert_block_chains`, chosen before the
launch), which bounds n_pad by `PEIKERT_TC_MAX_N_PAD` (3,584; above every
n_pad that B2-B4 reach).

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
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import count
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
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

TWO_PI = 2.0 * math.pi
SMEM_PER_BLOCK = 232_448   # bytes of shared memory a block of sm_90 may take
# chains a block of peikert_tc.cu may own, most first
BLOCK_CHAINS = (32, 16)
# the largest n_pad whose normals tile (16 chains x n_pad float32) fits a
# block's shared memory, rounded down to a multiple of 64: 3,584
PEIKERT_TC_MAX_N_PAD = (SMEM_PER_BLOCK // (4 * BLOCK_CHAINS[-1])
                        // ROW_BLOCK * ROW_BLOCK)


def peikert_block_chains(n_pad: int) -> int:
    """The chains a block of B5 owns at n_pad: the most of `BLOCK_CHAINS`
    whose normals tile (4 n_pad bytes a chain) fits `SMEM_PER_BLOCK`, so 32
    up to n_pad 1,792 and 16 up to `PEIKERT_TC_MAX_N_PAD`. Raises above."""
    for chains in BLOCK_CHAINS:
        if 4 * chains * n_pad <= SMEM_PER_BLOCK:
            return chains
    raise ValueError(
        f"n_pad {n_pad} is above {PEIKERT_TC_MAX_N_PAD}, the largest whose "
        f"normals tile of {BLOCK_CHAINS[-1]} chains fits a block's shared "
        "memory")


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
    with span("lgm.setup.operands"):
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


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 x truncated to TF32 (sign, exponent and 10 mantissa bits):
    peikert_tc.cu's `KEEP` mask, bit for bit."""
    bits = x.to(torch.float32).view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = x truncated to TF32 and hi + lo = x exactly in
    float32; the kernel truncates lo to TF32 too (`tf32_trunc(lo)`,
    peikert_tc.cu `split`)."""
    x = x.to(torch.float32)
    hi = tf32_trunc(x)
    return hi, x - hi


def _fragment_index_k8(device):
    """Rows and columns (32, 4) of a 16 x 8 tile that lane l holds as
    registers a0..a3 of mma.sync m16n8k8 .tf32's A operand: g = l / 4,
    t = l % 4, (g, t), (g+8, t), (g, t+4), (g+8, t+4)."""
    lane = torch.arange(32, device=device)
    g, t = lane // 4, lane % 4
    return (torch.stack([g, g + 8, g, g + 8], dim=1),
            torch.stack([t, t, t + 4, t + 4], dim=1))


def fragment_pack_k8(A: torch.Tensor) -> torch.Tensor:
    """(n_pad, n_pad) float32 -> (n_pad/16, n_pad/8, 32, 4): entry [mt, kt,
    lane] is lane's A fragment of the tile (rows 16 mt .., columns 8 kt ..),
    one 16-byte load per lane."""
    n_pad = A.shape[0]
    rows, cols = _fragment_index_k8(A.device)
    tiles = A.reshape(n_pad // 16, 16, n_pad // 8, 8).permute(0, 2, 1, 3)
    return tiles[:, :, rows, cols].contiguous()


def peikert_fragments(ops: PeikertOperands) -> torch.Tensor:
    """B5's product operand, (n_pad/16, n_pad/8, 32, 4) float32: L2 (the
    transpose of ops.L2T) in A-fragment order, built at the first launch
    and kept on `ops`."""
    frag = getattr(ops, "_tc_fragments", None)
    if frag is None:
        frag = fragment_pack_k8(ops.L2T.T.contiguous().to(torch.float32))
        ops._tc_fragments = frag
    return frag


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
                         chain_offset: int = 0, uniforms=None, normals=None,
                         centres=None):
    """Plain version of B5: returns the ring (n_rounds * n_pad, B). With
    `centres` (n_pad, B), round 0's centres c = c' - L2 z go there."""
    n_pad, dt, dev = ops.n_pad, ops.L2T.dtype, ops.device
    if (uniforms is None) != (normals is None):
        raise ValueError("pass both host uniforms and normals, or neither")
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
        if centres is not None and k == 0:
            centres.copy_(c)
        ring[rows], _ = _draw_row_plain(c, isg, u, ops.window)
    return ring


def ring_coeffs(ops: PeikertOperands, ring: torch.Tensor) -> torch.Tensor:
    """Ring (n_rounds * n_pad, B) -> (n_rounds, B, n) coefficients."""
    n_rounds = ring.shape[0] // ops.n_pad
    return ring.reshape(n_rounds, ops.n_pad, -1)[:, :ops.n].transpose(1, 2)


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------


def _peikert_tc_launch(ops: PeikertOperands, num_chains: int,
                       n_rounds: int, seed: int, chain_offset: int, uniforms,
                       normals, what: str, dbg=None):
    """Launch peikert_tc.cu's kernel; returns the ring (n_rounds * n_pad,
    B). Raises on bad input or a launch error; does not wait."""
    n_pad = ops.n_pad
    if n_pad % ROW_BLOCK:
        raise ValueError(f"n_pad {n_pad} is not a multiple of {ROW_BLOCK}")
    if n_pad > PEIKERT_TC_MAX_N_PAD:
        raise ValueError(
            f"{what}: n_pad {n_pad} is above {PEIKERT_TC_MAX_N_PAD}, the "
            f"largest whose normals tile of {BLOCK_CHAINS[-1]} chains fits a "
            "block's shared memory")
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
    lib = load("peikert_tc")
    frag = peikert_fragments(ops)
    ring = torch.empty(n_rounds * n_pad, num_chains, dtype=torch.float32,
                       device=ops.device)
    k0, k1 = seed_key(seed)
    rc = lib.peikert_tc_launch(
        ptr(frag), ptr(ops.cp), ops.isg,
        ptr(uniforms) if uniforms is not None else None,
        ptr(normals) if normals is not None else None, ptr(ring),
        ptr(dbg) if dbg is not None else None, n_pad, num_chains,
        ops.window, n_rounds, peikert_block_chains(n_pad), k0, k1,
        chain_offset,
        ctypes.c_void_p(torch.cuda.current_stream(ops.device).cuda_stream))
    raise_on("peikert_tc", rc, what)
    return ring


def peikert_rounds(ops: PeikertOperands, num_chains: int,
                   n_rounds: int = 1, *, seed: int = 0,
                   chain_offset: int = 0, uniforms=None, normals=None):
    """B5: n_rounds independent Peikert draws per chain in one launch.
    Returns the ring (n_rounds * n_pad, B). CPU operands run
    `peikert_rounds_plain`."""
    with span("lgm.kernel.b5"):
        if ops.device.type == "cpu":
            return peikert_rounds_plain(ops, num_chains, n_rounds, seed=seed,
                                        chain_offset=chain_offset,
                                        uniforms=uniforms, normals=normals)
        ring = _peikert_tc_launch(ops, num_chains, n_rounds, seed,
                                  chain_offset, uniforms, normals,
                                  "peikert_rounds")
        count("peikert_rounds")
        return ring


def peikert_centres(ops: PeikertOperands, num_chains: int, *,
                    seed: int = 0, chain_offset: int = 0, uniforms=None,
                    normals=None):
    """B5's debug instantiation: one round that also writes its centres
    c = c' - L2 z as the kernel forms them. Returns (centres (n_pad, B),
    ring (n_pad, B)). For holding the kernel's own centres to float64; not
    a launch of the main path. CPU operands run the plain version."""
    centres = torch.empty(ops.n_pad, num_chains, dtype=ops.L2T.dtype,
                          device=ops.device)
    if ops.device.type == "cpu":
        ring = peikert_rounds_plain(ops, num_chains, 1, seed=seed,
                                    chain_offset=chain_offset,
                                    uniforms=uniforms, normals=normals,
                                    centres=centres)
    else:
        ring = _peikert_tc_launch(ops, num_chains, 1, seed, chain_offset,
                                  uniforms, normals, "peikert_centres",
                                  dbg=centres)
    return centres, ring

