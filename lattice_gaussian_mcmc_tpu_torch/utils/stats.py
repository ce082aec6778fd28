"""Numerically stable log-space helpers (counterpart of the JAX package's
`utils/stats.py`), on torch tensors of any device and dtype."""

from __future__ import annotations

import math

import torch


def logsumexp(a, axis=None, b=None, keepdims=False):
    """log sum exp(a) over `axis` (all elements when None), with optional
    weights b: log sum b exp(a)."""
    a = torch.as_tensor(a)
    dims = tuple(range(a.ndim)) if axis is None else axis
    if b is None:
        return torch.logsumexp(a, dim=dims, keepdim=keepdims)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    a, b = torch.broadcast_tensors(a, b)
    m = torch.amax(torch.where(b != 0, a, a.new_tensor(-math.inf)), dim=dims,
                   keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(b * torch.exp(a - m), dim=dims, keepdim=True)
    out = torch.log(s) + m
    return out if keepdims else out.squeeze(dims)


def log_softmax(a, axis=-1):
    a = torch.as_tensor(a)
    return a - torch.logsumexp(a, dim=axis, keepdim=True)


def softmax(a, axis=-1):
    return torch.exp(log_softmax(a, axis=axis))


def logmeanexp(a, axis=None):
    a = torch.as_tensor(a)
    n = a.numel() if axis is None else a.shape[axis]
    return logsumexp(a, axis=axis) - math.log(n)
