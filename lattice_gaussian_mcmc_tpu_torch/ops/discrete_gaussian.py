"""Windowed 1D discrete Gaussian over Z: logits, log-normalizer, the
inverse-CDF draw and the Gumbel-max draw (counterpart of the JAX package's
`ops/discrete_gaussian.py`).

The window is W integers [-W/2, W/2 - 1] around base = round(center);
`torch.round` rounds half to even, as `jnp.round` does. Randomness is an
argument: the caller passes the uniforms, so the same uniforms give the same
draws in both packages.
"""

from __future__ import annotations

import torch

DEFAULT_WINDOW = 64


def window_offsets(window: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Static integer offsets [-W/2, ..., W/2 - 1] around the rounded center."""
    return torch.arange(window, dtype=dtype, device=device) - window // 2


def dgauss_logits(center, sigma, window: int = DEFAULT_WINDOW):
    """(support, logits) of D_{Z, sigma, center} on the window:
    support[..., k] = round(center) + k - W/2,
    logits[..., k] = -(support[..., k] - center)^2 / (2 sigma^2)."""
    center = torch.as_tensor(center)
    sigma = torch.as_tensor(sigma, dtype=center.dtype, device=center.device)
    base = torch.round(center)
    offs = window_offsets(window, dtype=center.dtype, device=center.device)
    support = base[..., None] + offs
    z = (support - center[..., None]) / sigma[..., None]
    return support, -0.5 * z * z


def log_partition_window(center, sigma, window: int = DEFAULT_WINDOW):
    """log Z = log sum_{z in window} rho_{sigma,center}(z): the exact
    normalizer of the windowed proposal."""
    _, logits = dgauss_logits(center, sigma, window)
    return torch.logsumexp(logits, dim=-1)


def sample_dgauss_icdf_with_logz(u, center, sigma,
                                 window: int = DEFAULT_WINDOW):
    """Inverse-CDF draw on the window plus its log-normalizer, from uniforms
    `u` in [0, 1) broadcastable against `center`. Returns (z, log_Z) with z
    a float tensor of integer values."""
    center = torch.as_tensor(center)
    _, logits = dgauss_logits(center, sigma, window)
    m = torch.max(logits, dim=-1).values
    w = torch.exp(logits - m[..., None])
    cdf = torch.cumsum(w, dim=-1)
    total = cdf[..., -1]
    target = (torch.as_tensor(u, dtype=center.dtype, device=center.device)
              * total)[..., None]
    idx = torch.sum((cdf < target).to(torch.int64), dim=-1)
    idx = torch.clamp(idx, 0, window - 1)
    z = torch.round(center) - window // 2 + idx.to(center.dtype)
    return z, m + torch.log(total)


def sample_dgauss(u, center, sigma, window: int = DEFAULT_WINDOW):
    """Gumbel-max draw of D_{Z, sigma, center} on the window: u holds W
    uniforms per draw (shape (..., W), broadcastable against
    center[..., None]), Gumbel noise g = -log(-log(max(u, tiny))),
    z = support[argmax(logits + g)]. Exact categorical sampling on the
    window, the JAX package's law."""
    support, logits = dgauss_logits(center, sigma, window)
    u = torch.as_tensor(u, dtype=logits.dtype, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(logits.dtype).tiny)
    idx = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    return torch.take_along_dim(support, idx[..., None], dim=-1)[..., 0]
