"""The port's windowed 1D discrete Gaussian against the JAX package's on
the same uniforms: draws, log-normalizers, and round-half-to-even at
half-integer centres."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.ops import discrete_gaussian as jdg
from lattice_gaussian_mcmc_tpu_torch.ops import discrete_gaussian as dg


def _centres():
    rng = np.random.default_rng(4)
    half = np.arange(-6, 6) + 0.5          # ties of round(): half to even
    return np.concatenate([half, rng.normal(scale=20.0, size=500)])


@pytest.mark.parametrize("sigma,window", [(0.35, 16), (1.7, 24), (3.0, 40)])
def test_icdf_draw_matches_jax(sigma, window):
    c = _centres()
    key = jax.random.key(int(10 * sigma))
    zj, lzj = jdg.sample_dgauss_icdf_with_logz(key, jnp.asarray(c), sigma,
                                               window)
    # the uniforms the JAX function draws internally (same key, shape, dtype)
    u = np.array(jax.random.uniform(key, c.shape, dtype=jnp.float64))
    z, lz = dg.sample_dgauss_icdf_with_logz(torch.from_numpy(u),
                                            torch.from_numpy(c), sigma,
                                            window)
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    # float64 log-sum of <= 40 terms in another order: rounding only
    np.testing.assert_allclose(lz.numpy(), np.asarray(lzj), atol=1e-6)


def test_round_half_to_even_base():
    c = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    support, _ = dg.dgauss_logits(c, torch.tensor(1.0), 8)
    np.testing.assert_array_equal(support[:, 4].numpy(),
                                  [0.0, 2.0, 2.0, -0.0, -2.0])


def test_logits_and_partition_match_jax():
    c = _centres()
    s = np.full_like(c, 0.9)
    sj, lj = jdg.dgauss_logits(jnp.asarray(c), jnp.asarray(s), 24)
    st, lt = dg.dgauss_logits(torch.from_numpy(c), torch.from_numpy(s), 24)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        dg.log_partition_window(torch.from_numpy(c), 0.9, 24).numpy(),
        np.asarray(jdg.log_partition_window(jnp.asarray(c), 0.9, 24)),
        atol=1e-12)
    np.testing.assert_array_equal(dg.window_offsets(6).numpy(),
                                  np.asarray(jdg.window_offsets(6)))


def test_draw_law_matches_exact_pmf():
    """10^5 draws at one centre against the exact pmf (TVD gate 0.02)."""
    sigma, centre, W = 1.3, 0.37, 24
    g = torch.Generator().manual_seed(0)
    u = torch.rand(100_000, generator=g, dtype=torch.float64)
    z, _ = dg.sample_dgauss_icdf_with_logz(
        u, torch.full((100_000,), centre, dtype=torch.float64), sigma, W)
    support, p = jdg.exact_pmf(sigma, centre)
    emp = np.array([(z.numpy() == k).mean() for k in support])
    assert 0.5 * np.abs(emp - p).sum() < 0.02
