"""The windowed discrete Gaussian over Z by inverse CDF, in float64, and the
rounding helpers of the control (one precision below what a configuration
states).

A draw of width s around c takes the W integers round(c) - W/2 ..
round(c) + W/2 - 1 (round half to even), weights exp(-(z - c)^2 / 2 s^2),
and returns the first support point whose running weight reaches u times
the total; log Z is the log of that total.
"""

from __future__ import annotations

import torch


def icdf(u: torch.Tensor, c: torch.Tensor, s, window: int):
    """Draws (z, log Z) for uniforms u and centres c, any equal shapes; s a
    scalar or broadcastable tensor of widths."""
    base = torch.round(c)
    offs = torch.arange(window, dtype=c.dtype, device=c.device) - window // 2
    d = (base[..., None] + offs - c[..., None]) / torch.as_tensor(
        s, dtype=c.dtype, device=c.device)[..., None]
    logits = -0.5 * d * d
    m = logits.max(dim=-1).values
    cdf = torch.cumsum(torch.exp(logits - m[..., None]), dim=-1)
    total = cdf[..., -1]
    idx = (cdf < (u * total)[..., None]).sum(dim=-1).clamp(max=window - 1)
    return base - window // 2 + idx.to(c.dtype), m + torch.log(total)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)
