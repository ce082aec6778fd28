"""The port's MCMC diagnostics against the JAX package's on the same numpy
chains, in float64. The two compute the same reductions (FFT ACF, Sokal
window, batch means) in another order, so they agree to rounding: 1e-6
relative is a wide margin for chains of a few thousand steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.diagnostics import mcmc as jd
from lattice_gaussian_mcmc_tpu_torch.diagnostics import mcmc as td

RTOL = 1e-6


def _ar1(rng, T, phi, d=None):
    shape = (T,) if d is None else (T, d)
    e = rng.normal(size=shape)
    x = np.empty(shape)
    x[0] = e[0]
    for t in range(1, T):
        x[t] = phi * x[t - 1] + e[t]
    return x


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_scalar_chain_metrics_match_jax(phi):
    rng = np.random.default_rng(int(10 * phi) + 1)
    x = _ar1(rng, 3000, phi)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(td.autocorrelation(xt, 64), jd.autocorrelation(xj, 64))
    _close(td.integrated_autocorr_time(xt, 128),
           jd.integrated_autocorr_time(xj, 128))
    _close(td.effective_sample_size(xt, 128),
           jd.effective_sample_size(xj, 128))
    _close(td.ess_batch_means(xt), jd.ess_batch_means(xj))
    _close(td.mcse(xt), jd.mcse(xj))
    _close(td.mcse_spectral(xt), jd.mcse_spectral(xj))


def test_short_chain_and_multivariate_match_jax():
    rng = np.random.default_rng(4)
    short = rng.normal(size=40)     # fewer lags than max_lag
    _close(td.integrated_autocorr_time(torch.from_numpy(short), 256),
           jd.integrated_autocorr_time(jnp.asarray(short), 256))
    chain = _ar1(rng, 2000, 0.7, d=3)
    ct, cj = torch.from_numpy(chain), jnp.asarray(chain)
    _close(td.effective_sample_size(ct, 64), jd.effective_sample_size(cj, 64))
    got, want = td.diagnose_chain(ct, 64), jd.diagnose_chain(cj, 64)
    assert got["n_samples"] == want["n_samples"]
    for k in ("ess_min", "ess_per_sample", "tau_int_max", "mean", "std",
              "mean_jump", "std_jump", "frac_zero"):
        _close(got[k], want[k])
    _close(td.acceptance_rate(37, 100), jd.acceptance_rate(37, 100))


def test_pooled_acf_and_sokal_tau_match_jax():
    rng = np.random.default_rng(5)
    ring = _ar1(rng, 48, 0.4, d=500)        # (T, B) trajectory ring
    rho = td.pooled_acf(torch.from_numpy(ring), max_lag=24)
    _close(rho, jd.pooled_acf(jnp.asarray(ring), max_lag=24))
    assert rho.shape == (24,) and float(rho[0]) == 1.0
    # the hard-regime bench row's rule: 1/2 + sum of rho until < 0.05;
    # for AR(1) with phi = 0.4 that is about 1/2 + 0.4 + 0.16 + 0.064
    tau = td.sokal_tau(rho)
    want = 0.5
    for lag in range(1, 24):
        if float(rho[lag]) < 0.05:
            break
        want += float(rho[lag])
    assert tau == want and 0.9 < tau < 1.4
