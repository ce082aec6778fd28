"""Windowed 1D discrete Gaussian over Z: logits, log-normalizer, the
inverse-CDF and Gumbel-max draws, the CDT table sampler, the rounding
rejection sampler and the exact pmf (counterpart of the JAX package's
`ops/discrete_gaussian.py`).

The window is W integers [-W/2, W/2 - 1] around base = round(center);
`torch.round` rounds half to even, as `jnp.round` does. Randomness is an
argument: the caller passes the uniforms (and normals), so the same random
numbers give the same draws in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device

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
    z, _ = sample_dgauss_with_logz(u, center, sigma, window)
    return z


def sample_dgauss_with_logz(u, center, sigma, window: int = DEFAULT_WINDOW):
    """`sample_dgauss`'s Gumbel-max draw z from the uniforms u (..., W),
    and log Z of the window, the value `log_partition_window` gives.
    Returns (z, log_Z), z a float tensor of integer values."""
    support, logits = dgauss_logits(center, sigma, window)
    u = torch.as_tensor(u, dtype=logits.dtype, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(logits.dtype).tiny)
    idx = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    z = torch.take_along_dim(support, idx[..., None], dim=-1)[..., 0]
    return z, torch.logsumexp(logits, dim=-1)


def sample_dgauss_inverse_cdf(u, center, sigma, window: int = DEFAULT_WINDOW):
    """Inverse-CDF draw on the window from uniforms `u` (one per draw):
    `sample_dgauss_icdf_with_logz` without the log-normalizer."""
    z, _ = sample_dgauss_icdf_with_logz(u, center, sigma, window)
    return z


# ---------------------------------------------------------------------------
# CDT sampler for a fixed (sigma, center).
# ---------------------------------------------------------------------------


def build_cdt(sigma: float, center: float = 0.0, tau: float = 10.0,
              device=None):
    """Cumulative distribution table of D_{Z, sigma, center} on
    [round(c) - h, round(c) + h], h = ceil(tau sigma) + 1, built in float64
    on the host and stored as float32 tensors on `device` (the card unless
    asked): {"support": (K,), "cdf": (K,)} with cdf[-1] == 1."""
    device = resolve_device(device)
    half = int(math.ceil(tau * float(sigma))) + 1
    base = int(round(center))
    support = np.arange(base - half, base + half + 1, dtype=np.float64)
    logits = -0.5 * ((support - center) / sigma) ** 2
    p = np.exp(logits - logits.max())
    p /= p.sum()
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    return {"support": torch.tensor(support, dtype=torch.float32,
                                     device=device),
            "cdf": torch.tensor(cdf, dtype=torch.float32, device=device)}


def sample_cdt(u, cdt):
    """Table lookup: the first support point whose cdf exceeds u, one
    uniform per draw (any shape)."""
    cdf = cdt["cdf"]
    u = torch.as_tensor(u, device=cdf.device).to(cdf.dtype)
    idx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    idx = idx.clamp_(0, cdf.shape[0] - 1)
    return cdt["support"][idx].reshape(u.shape)


# ---------------------------------------------------------------------------
# Rounding-rejection sampler (no table, no window).
# ---------------------------------------------------------------------------


def sample_dgauss_rejection(normals, uniforms, center, sigma):
    """Propose y = center + sigma * normal, z = round(y), accept with
    rho(z) / rho(y) = exp(-((z - c)^2 - (y - c)^2) / (2 sigma^2)); the first
    accepted round wins, round(center) if none is. `normals` and `uniforms`
    are (rounds, *shape), one row per round; the uniforms should exclude 0
    (the JAX function draws them from [tiny, 1))."""
    normals = torch.as_tensor(normals)
    center = torch.as_tensor(center, dtype=normals.dtype,
                             device=normals.device)
    sigma = torch.as_tensor(sigma, dtype=normals.dtype, device=normals.device)
    uniforms = torch.as_tensor(uniforms, device=normals.device).to(
        normals.dtype)
    shape = torch.broadcast_shapes(center.shape, sigma.shape,
                                   normals.shape[1:])
    z_acc = torch.round(center).expand(shape).clone()
    done = torch.zeros(shape, dtype=torch.bool, device=normals.device)
    for k in range(normals.shape[0]):
        y = center + sigma * normals[k]
        z = torch.round(y)
        log_acc = -((z - center) ** 2 - (y - center) ** 2) / (
            2.0 * sigma ** 2)
        acc = torch.log(uniforms[k]) < log_acc
        z_acc = torch.where(acc & ~done, z, z_acc)
        done |= acc
    return z_acc


# ---------------------------------------------------------------------------
# Exact pmf (host, for statistical validation).
# ---------------------------------------------------------------------------


def exact_pmf(sigma: float, center: float = 0.0, tau: float = 12.0):
    """Exact (up to a tail < e^{-tau^2/2}) pmf of D_{Z, sigma, center} as
    numpy arrays (support int64, probs float64)."""
    half = int(math.ceil(tau * float(sigma))) + 2
    base = int(round(center))
    support = np.arange(base - half, base + half + 1, dtype=np.int64)
    logits = -0.5 * ((support - center) / sigma) ** 2
    p = np.exp(logits - logits.max())
    p /= p.sum()
    return support, p
