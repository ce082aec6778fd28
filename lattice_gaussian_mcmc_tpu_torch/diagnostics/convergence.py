"""Convergence metrics: TVD, Gelman-Rubin R-hat, Wasserstein, mixing time,
batch means, two-sample KS (counterpart of the JAX package's
`diagnostics/convergence.py`). The tensor reductions run on the input's
device and dtype; the exact-support TVD and KL run on the host in numpy,
as in the reference. Where the JAX function takes a `jax.random` key, this
one takes an integer seed (a `torch.Generator` on the data's device).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tvd_discrete(samples_a, samples_b):
    """TVD between two empirical distributions over integer vectors
    (host-side; exact over observed support)."""
    a = _host(samples_a).astype(np.int64)
    b = _host(samples_b).astype(np.int64)
    keys_a, counts_a = np.unique(a, axis=0, return_counts=True)
    keys_b, counts_b = np.unique(b, axis=0, return_counts=True)
    da = {tuple(k): c / len(a) for k, c in zip(keys_a, counts_a)}
    db = {tuple(k): c / len(b) for k, c in zip(keys_b, counts_b)}
    keys = set(da) | set(db)
    return 0.5 * sum(abs(da.get(k, 0.0) - db.get(k, 0.0)) for k in keys)


def tvd_histogram(x, y, n_bins: int = 64, lo=None, hi=None):
    """Binned TVD between two scalar sample sets over n_bins equal bins of
    [lo, hi] (the joint range by default)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if lo is None:
        lo = torch.minimum(x.min(), y.min())
    if hi is None:
        hi = torch.maximum(x.max(), y.max())
    scale = (hi - lo) / n_bins

    def hist(v):
        idx = torch.clamp(((v - lo) / scale).to(torch.int32), 0, n_bins - 1)
        h = torch.zeros(n_bins, dtype=v.dtype, device=v.device)
        return h.index_add_(0, idx, torch.ones_like(v)) / v.shape[0]

    return 0.5 * torch.sum(torch.abs(hist(x) - hist(y)))


def tvd_vs_exact(samples, support, probs):
    """TVD of integer samples vs an exact pmf on `support` (host-side;
    mass outside the support counts fully)."""
    samples = _host(samples).astype(np.int64)
    support = np.asarray(support)
    probs = np.asarray(probs)
    lo, hi = support[0], support[-1]
    inside = (samples >= lo) & (samples <= hi)
    counts = np.bincount(samples[inside] - lo, minlength=len(support))
    emp = counts / len(samples)
    tvd = 0.5 * (np.abs(emp - probs).sum() + (1 - inside.mean()))
    return float(tvd)


def kl_divergence_discrete(samples, support, probs, eps: float = 1e-12):
    """KL(empirical || exact) over the support (reference gate KL < 0.05)."""
    samples = _host(samples).astype(np.int64)
    probs = np.asarray(probs)
    lo, hi = support[0], support[-1]
    inside = (samples >= lo) & (samples <= hi)
    counts = np.bincount(samples[inside] - lo, minlength=len(support))
    emp = counts / max(inside.sum(), 1)
    mask = emp > 0
    return float(np.sum(emp[mask] * np.log(emp[mask] / (probs[mask] + eps))))


def gelman_rubin(chains):
    """Gelman-Rubin R-hat. chains: (C, T) scalar or (C, T, d) (per-dim for
    the latter). R-hat = sqrt(((T-1)/T W + B/T) / W)."""
    chains = torch.as_tensor(chains)
    if chains.ndim == 2:
        chains = chains[..., None]
    C, T, d = chains.shape
    means = torch.mean(chains, dim=1)
    variances = torch.var(chains, dim=1, correction=1)
    W = torch.mean(variances, dim=0)
    B = T * torch.var(means, dim=0, correction=1)
    var_hat = (T - 1) / T * W + B / T
    rhat = torch.sqrt(var_hat / torch.clamp(W, min=1e-300))
    return rhat.squeeze()


def wasserstein_1d(x, y):
    """W1 between two equal-size 1D sample sets = mean |sorted diff|."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return torch.mean(torch.abs(torch.sort(x).values - torch.sort(y).values))


def _sliced_w1(X, Y, dirs):
    """Mean over the rows of `dirs` (unnormalised directions) of the W1 of
    the projections."""
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    px = torch.sort(X @ dirs.T, dim=0).values
    py = torch.sort(Y @ dirs.T, dim=0).values
    return torch.mean(torch.mean(torch.abs(px - py), dim=0))


def sliced_wasserstein(seed: int, X, Y, n_proj: int = 32):
    """Sliced W1 for multivariate samples: average W1 over n_proj random
    directions, drawn from `seed`."""
    X, Y = torch.as_tensor(X), torch.as_tensor(Y)
    gen = torch.Generator(device=X.device).manual_seed(int(seed))
    dirs = torch.randn(n_proj, X.shape[1], generator=gen, dtype=X.dtype,
                       device=X.device)
    return _sliced_w1(X, Y, dirs)


def mixing_time_from_tvd(tvds, threshold: float = 0.25):
    """First index where TVD drops (and stays) below threshold."""
    tvds = _host(tvds)
    below = tvds < threshold
    stay = np.logical_and.accumulate(below[::-1])[::-1]
    idx = np.argmax(stay)
    return int(idx) if stay.any() else len(tvds)


def batch_means_variance(x, n_batches: int = 32):
    """Long-run variance estimate sigma^2 = B * var(batch means)."""
    x = torch.as_tensor(x)
    B = x.shape[0] // n_batches
    xb = x[:n_batches * B].reshape(n_batches, B)
    return B * torch.var(torch.mean(xb, dim=1), correction=1)


def ks_2sample(x, y):
    """Two-sample Kolmogorov-Smirnov test as a sort / searchsorted
    reduction. Returns (D, p_asymptotic); p from the asymptotic Kolmogorov
    series Q(lam) = 2 sum_k (-1)^{k-1} exp(-2 k^2 lam^2), 32 terms, with
    Stephens' small-sample correction, and 1 for lam < 0.3 (where the
    truncated series is wrong and Q is 1 to ~1e-9)."""
    x = torch.sort(torch.as_tensor(x).reshape(-1)).values
    y = torch.sort(torch.as_tensor(y).reshape(-1)).values
    n, m = x.shape[0], y.shape[0]
    allv = torch.cat([x, y])
    cdf_x = torch.searchsorted(x, allv, right=True).to(x.dtype) / n
    cdf_y = torch.searchsorted(y, allv, right=True).to(x.dtype) / m
    d = torch.max(torch.abs(cdf_x - cdf_y))
    en = (n * m / (n + m)) ** 0.5
    lam = (en + 0.12 + 0.11 / en) * d
    k = torch.arange(1, 33, dtype=x.dtype, device=x.device)
    p = 2.0 * torch.sum((-1.0) ** (k - 1) * torch.exp(-2.0 * (k * lam) ** 2))
    p = torch.where(lam < 0.3, torch.ones_like(p), p)
    return d, torch.clamp(p, 0.0, 1.0)
