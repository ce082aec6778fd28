"""Blocked Klein sampling in PyTorch: padding, and the (B, n)-layout
blocked draw and fused IMHK steps (counterpart of the JAX package's
`samplers/klein_blocked.py`).

These run the plain version of the Klein kernel (`ops/kernels/klein_cuda.py`)
in the precomputation's own dtype on its own device: cross-block
conditional-mean contributions are one matrix product per 64-row block, the
rows inside a block go one by one. In float64 they are the oracle the f32
kernel is held to.
"""

from __future__ import annotations

import dataclasses

import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels.klein_cuda import (
    from_kernel_layout,
    imhk_fused_plain,
    kernel_operands,
    klein_draw_plain,
    to_kernel_layout,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import KleinPrecomp

DEFAULT_BLOCK = 128


def _pad_precomp(pre: KleinPrecomp, block: int = DEFAULT_BLOCK):
    """Pad U/cs/sigmas so n is a multiple of `block`. Padded rows get U = I,
    sigma = 1e-6 and cs = 0, so they draw 0 with log Z = 0 and never touch
    the real rows (the off-diagonal padding of U is zero).
    Returns (padded precomp, n)."""
    n = pre.n
    n_pad = (-n) % block
    if n_pad == 0:
        return pre, n
    dtype, dev = pre.U.dtype, pre.device
    U = torch.zeros(n + n_pad, n + n_pad, dtype=dtype, device=dev)
    U[:n, :n] = pre.U
    idx = torch.arange(n, n + n_pad, device=dev)
    U[idx, idx] = 1.0
    cs = torch.cat([pre.cs, torch.zeros(n_pad, dtype=dtype, device=dev)])
    sigmas = torch.cat([pre.sigmas,
                        torch.full((n_pad,), 1e-6, dtype=dtype, device=dev)])
    return dataclasses.replace(pre, U=U, cs=cs, sigmas=sigmas), n


def klein_sample_batch_blocked(pre: KleinPrecomp, num_samples: int,
                               seed: int = 0, step: int = 0,
                               chain_offset: int = 0, uniforms=None):
    """Blocked Klein draw in the precomputation's dtype.
    Returns (coeffs (B, n), log_w (B,))."""
    ops = kernel_operands(pre, dtype=pre.U.dtype)
    y, lw = klein_draw_plain(ops, num_samples, seed=seed, step=step,
                             chain_offset=chain_offset, uniforms=uniforms)
    return from_kernel_layout(ops, y), lw


def imhk_steps_batch_blocked(pre: KleinPrecomp, coeffs, log_ws,
                             n_steps: int, seed: int = 0, step: int = 1,
                             chain_offset: int = 0):
    """n_steps IMHK steps with the blocked proposal in the precomputation's
    dtype. Returns (coeffs, log_ws, accepted count int32)."""
    ops = kernel_operands(pre, dtype=pre.U.dtype)
    x = to_kernel_layout(ops, coeffs)
    lw = log_ws.to(pre.U.dtype).clone()
    acc = torch.zeros_like(lw)
    imhk_fused_plain(ops, x, lw, acc, n_steps, seed=seed, step=step,
                     chain_offset=chain_offset)
    return from_kernel_layout(ops, x), lw, acc.to(torch.int32)
