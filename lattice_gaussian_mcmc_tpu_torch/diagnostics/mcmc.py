"""MCMC chain metrics as tensor reductions (counterpart of the JAX
package's `diagnostics/mcmc.py`).

ACF by FFT zero-padded to 2T (no circular wrap); Sokal's adaptive window for
tau_int taken with static shapes (tau(W) for every W, then the first
admissible W); ESS = T / tau_int, the minimum over dimensions for a
multivariate chain. Everything runs on the chain's own device and dtype.
"""

from __future__ import annotations

import torch


def _tiny(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).tiny


def autocorrelation(x: torch.Tensor, max_lag: int = 256) -> torch.Tensor:
    """Normalized ACF of a scalar chain x (T,) up to max_lag, by FFT."""
    T = x.shape[0]
    xc = x - x.mean()
    f = torch.fft.rfft(xc, n=2 * T)
    acov = torch.fft.irfft(f * f.conj(), n=2 * T)[:T] / T
    acf = acov / torch.clamp(acov[0], min=_tiny(x))
    return acf[:max_lag + 1]


def pooled_acf(ring: torch.Tensor, max_lag: int = 24) -> torch.Tensor:
    """Cross-chain pooled ACF of a (T, B) trajectory ring, on its device.

    Each chain is centred over time; the lag-l autocovariance pools the
    products over every chain and admissible time pair. Returns lags
    0..max_lag-1 (max_lag values)."""
    T = ring.shape[0]
    xc = ring - ring.mean(dim=0, keepdim=True)
    num = [torch.mean(xc * xc)]
    for lag in range(1, max_lag):
        num.append(torch.mean(xc[:T - lag] * xc[lag:]))
    num = torch.stack(num)
    return num / torch.clamp(num[0], min=_tiny(ring))


def integrated_autocorr_time(x: torch.Tensor, max_lag: int = 256,
                             c: float = 5.0) -> torch.Tensor:
    """tau_int with Sokal's window: tau(W) = 1 + 2 sum_{t<=W} acf(t), W the
    smallest lag with W >= c tau(W) (the last lag if none is); at least 1."""
    acf = autocorrelation(x, max_lag)
    L = acf.shape[0] - 1           # may be < max_lag for short chains
    taus = 1.0 + 2.0 * torch.cumsum(acf[1:], dim=0)
    w = torch.arange(1, L + 1, dtype=x.dtype, device=x.device)
    admissible = w >= c * taus
    idx = torch.argmax(admissible.to(torch.int8))
    tau = torch.where(admissible.any(), taus[idx], taus[-1])
    return torch.clamp(tau, min=1.0)


def effective_sample_size(x: torch.Tensor, max_lag: int = 256) -> torch.Tensor:
    """ESS = T / tau_int for a scalar chain (T,); for (T, d) the minimum
    over dimensions."""
    T = x.shape[0]
    if x.ndim == 1:
        return T / integrated_autocorr_time(x, max_lag)
    return torch.stack([T / integrated_autocorr_time(x[:, j], max_lag)
                        for j in range(x.shape[1])]).min()


def ess_batch_means(x: torch.Tensor, n_batches: int = 32) -> torch.Tensor:
    """Batch-means ESS: T var(x) / (b var(batch means)), b = T // n_batches."""
    T = x.shape[0]
    b = T // n_batches
    means = x[:n_batches * b].reshape(n_batches, b).mean(dim=1)
    var_bm = b * torch.var(means, correction=1)
    return T * torch.var(x, correction=1) / torch.clamp(var_bm, min=_tiny(x))


def acceptance_rate(accepted, total) -> torch.Tensor:
    return (torch.as_tensor(accepted, dtype=torch.float32)
            / torch.clamp(torch.as_tensor(total, dtype=torch.float32),
                          min=1.0))


def jump_distances(chain: torch.Tensor) -> dict:
    """Mean, std and zero share of consecutive jump norms of a (T, d)
    chain."""
    d = torch.linalg.vector_norm(torch.diff(chain, dim=0), dim=-1)
    return {"mean_jump": d.mean(), "std_jump": torch.std(d, correction=0),
            "frac_zero": (d == 0.0).to(chain.dtype).mean()}


def mcse(x: torch.Tensor, n_batches: int = 32) -> torch.Tensor:
    """Monte-Carlo standard error by batch means."""
    T = x.shape[0]
    b = T // n_batches
    means = x[:n_batches * b].reshape(n_batches, b).mean(dim=1)
    return torch.sqrt(b * torch.var(means, correction=1) / T)


def diagnose_chain(chain, max_lag: int = 256) -> dict:
    """Summary of one chain (T, d)."""
    chain = torch.as_tensor(chain)
    ess = effective_sample_size(chain, max_lag)
    return {
        "n_samples": chain.shape[0],
        "ess_min": ess,
        "ess_per_sample": ess / chain.shape[0],
        "tau_int_max": chain.shape[0] / torch.clamp(ess, min=1e-12),
        "mean": chain.mean(dim=0),
        "std": torch.std(chain, dim=0, correction=0),
        **jump_distances(chain),
    }


def mcse_spectral(x: torch.Tensor) -> torch.Tensor:
    """MCSE from the spectral density at zero, estimated by the mean
    periodogram over the lowest nonzero frequencies 1..max(T // 50, 2)."""
    T = x.shape[0]
    f = torch.fft.rfft(x - x.mean())
    psd = f.abs() ** 2 / T
    k = max(T // 50, 2)
    s0 = psd[1:k + 1].sum() / max(min(k, psd.shape[0] - 1), 1)
    return torch.sqrt(s0 / T)


def sokal_tau(rho, cutoff: float = 0.05) -> float:
    """tau_int from a pooled ACF rho (lags 0..L-1), the hard-regime bench
    row's rule: 1/2 plus rho(l) for l = 1, 2, ... until the first rho(l)
    below `cutoff` or the last lag."""
    rho = [float(r) for r in rho]
    tau = 0.5
    for lag in range(1, len(rho)):
        if rho[lag] < cutoff:
            break
        tau += rho[lag]
    return tau
