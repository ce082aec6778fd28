"""Blocked Klein sampling in PyTorch: the (B, n)-layout blocked draw and
fused IMHK steps (counterpart of the JAX package's
`samplers/klein_blocked.py`).

On a CUDA precomputation the draw launches kernel B1 and the steps kernel
B2 (`ops/kernels/klein_cuda.py`), on float32 operands; each call is one
launch whose wrapper reads its own hazard-C8 guard before it returns, and
the narrow or WIDE instantiation is `klein_cuda.wide_y`'s choice. On a CPU
precomputation they run the plain version of those kernels in the
precomputation's own dtype: cross-block conditional-mean contributions are
one matrix product per 64-row block, the rows inside a block go one by
one. In float64 the plain version is the oracle the float32 kernels are
held to.

The operands (and, on a card, U's tensor-core fragments) are built once per
precomputation and kept on it (`blocked_operands`), so a driver that draws
and then steps on one `pre` packs U once.
"""

from __future__ import annotations

import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.klein_cuda import (
    from_kernel_layout,
    kernel_operands,
    to_kernel_layout,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import KleinPrecomp


def blocked_operands(pre: KleinPrecomp) -> klein_cuda.KleinOperands:
    """The kernel operands of `pre`, built at the first call and kept on
    it: float32 on a card (B1's and B2's), the precomputation's dtype on
    the CPU (their plain versions')."""
    ops = getattr(pre, "_blocked_ops", None)
    if ops is None:
        dtype = (torch.float32 if pre.device.type == "cuda"
                 else pre.U.dtype)
        ops = kernel_operands(pre, dtype=dtype)
        pre._blocked_ops = ops
    return ops


def klein_sample_batch_blocked(pre: KleinPrecomp, num_samples: int,
                               seed: int = 0, step: int = 0,
                               chain_offset: int = 0, uniforms=None):
    """One Klein draw per chain: kernel B1 on a card, its plain version in
    the precomputation's dtype on the CPU. Chain c reads the Philox
    counters of chain `chain_offset + c` at `step`.
    Returns (coeffs (B, n), log_w (B,))."""
    ops = blocked_operands(pre)
    y, lw = klein_cuda.klein_draw(ops, num_samples, seed=seed, step=step,
                                  chain_offset=chain_offset,
                                  uniforms=uniforms)
    return from_kernel_layout(ops, y), lw


def imhk_steps_batch_blocked(pre: KleinPrecomp, coeffs, log_ws,
                             n_steps: int, seed: int = 0, step: int = 1,
                             chain_offset: int = 0):
    """n_steps IMHK steps with the Klein proposal, at Philox steps
    step .. step + n_steps - 1: one launch of kernel B2 on a card, its
    plain version in the precomputation's dtype on the CPU.
    Returns (coeffs, log_ws, accepted count int32)."""
    ops = blocked_operands(pre)
    x = to_kernel_layout(ops, coeffs)
    lw = log_ws.to(ops.U.dtype).clone()
    acc = torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, lw, acc, n_steps, seed=seed, step=step,
                          chain_offset=chain_offset)
    return from_kernel_layout(ops, x), lw, acc.to(torch.int32)
