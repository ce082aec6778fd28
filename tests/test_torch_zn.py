"""Z^n in the port against the JAX package: the plain version of kernel B8
against `sample_zn_pallas` in interpret mode on the wrapper's own uniforms,
`sample_zn`, the exact pmf, the CDT and rejection samplers, the theta
helpers and the identity lattice's closed forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lattice_gaussian_mcmc_tpu.lattices import identity as jid
from lattice_gaussian_mcmc_tpu.ops import discrete_gaussian as jdg
from lattice_gaussian_mcmc_tpu.ops import theta as jth
from lattice_gaussian_mcmc_tpu.ops.kernels.zn_pallas import sample_zn_pallas
from lattice_gaussian_mcmc_tpu_torch.lattices import identity as tid
from lattice_gaussian_mcmc_tpu_torch.ops import discrete_gaussian as dg
from lattice_gaussian_mcmc_tpu_torch.ops import theta as th
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import zn_cuda

ROWS, TILE = 8, 128
# A draw whose target u * total lies within float32 rounding of a CDF entry
# can land one apart when the two CDFs are summed in another order (Pallas:
# a bf16-split matrix product; the port: a sequential sum). Draws are
# independent, so a tie moves that one draw by one and nothing else.
MAX_TIE_SHARE = 1e-3


def _tvd(z, sigma, center=0.0):
    support, p = jdg.exact_pmf(sigma, center)
    emp = np.array([(z == k).mean() for k in support])
    return 0.5 * (np.abs(emp - p).sum() + (1.0 - emp.sum()))


@pytest.mark.parametrize("sigma,center,window", [
    (3.0, 0.0, 64), (1.5, 0.5, 32), (5.0, -2.5, 56)])
def test_b8_plain_matches_pallas_stream(sigma, center, window):
    key = jax.random.key(int(10 * sigma))
    num = 4 * ROWS * TILE
    with pltpu.force_tpu_interpret_mode():
        zp = np.asarray(sample_zn_pallas(key, num, sigma, center=center,
                                         window=window, rows=ROWS, tile=TILE,
                                         host_rng=True))
    # the wrapper's own uniforms (zn_pallas.py sample_zn_pallas)
    _, k_unif = jax.random.split(key)
    u = np.array(jax.random.uniform(k_unif, (num // TILE, TILE),
                                    dtype=jnp.float32)).reshape(-1)
    z = zn_cuda.sample_zn_draws(num, sigma, center, window,
                                uniforms=torch.from_numpy(u)).numpy()
    diff = z != zp
    assert diff.mean() <= MAX_TIE_SHARE, diff.sum()
    assert np.all(np.abs(z - zp)[diff] == 1)
    assert z.dtype == np.float32 and np.all(z == np.round(z))


def test_b8_plain_law_and_philox_stream():
    """TVD to the exact pmf (gate 0.02) on in-wrapper Philox uniforms; the
    draw index addresses the stream, so a prefix is the same draws."""
    z = zn_cuda.sample_zn_draws(200_000, 2.0, 0.0, 32, seed=3,
                                device="cpu").numpy()
    assert _tvd(z, 2.0) < 0.02
    z1 = zn_cuda.sample_zn_draws(1000, 2.0, 0.0, 32, seed=3, device="cpu")
    np.testing.assert_array_equal(z1.numpy(), z[:1000])


def test_b8_plain_counts_strictly_below():
    """idx = #{k : cdf_k < u total}: a uniform that puts the target exactly
    on a CDF entry k draws offset k, not k + 1."""
    base, cdf = zn_cuda.zn_cdf(1.5, 0.25, 16, "cpu")
    total = cdf[-1]
    u = cdf / total
    on = (u * total) == cdf            # targets exactly on an entry
    assert bool(on[:-1].any())
    z = zn_cuda.sample_zn_draws(16, 1.5, 0.25, 16, uniforms=u)
    k = torch.arange(16, dtype=torch.float32)
    assert torch.equal(z[on], (base + k - 8)[on])


def test_sample_zn_matches_jax():
    key = jax.random.key(7)
    n, B, sigma = 12, 500, 2.5
    zj = np.asarray(jid.sample_zn(key, n, sigma, shape=(B,), window=32))
    u = np.array(jax.random.uniform(key, (B, n), dtype=zj.dtype))
    z = tid.sample_zn(0, n, sigma, shape=(B,), window=32,
                      uniforms=torch.from_numpy(u),
                      dtype=torch.float64).numpy()
    np.testing.assert_array_equal(z, zj)
    # per-coordinate centres take the inverse-CDF path as well
    c = np.linspace(-3.0, 3.0, n)
    zj = np.asarray(jid.sample_zn(key, n, sigma, center=jnp.asarray(c),
                                  shape=(B,), window=32))
    z = tid.sample_zn(0, n, sigma, center=torch.from_numpy(c), shape=(B,),
                      window=32, uniforms=torch.from_numpy(u),
                      dtype=torch.float64).numpy()
    np.testing.assert_array_equal(z, zj)


def test_sample_zn_philox_law():
    z = tid.sample_zn(5, 4, 1.5, center=0.5, shape=(50_000,), window=32,
                      device="cpu").numpy()
    assert z.shape == (50_000, 4)
    assert _tvd(z.reshape(-1), 1.5, 0.5) < 0.02


def test_exact_pmf_matches_jax():
    for sigma, c in ((2.0, 0.0), (0.7, 0.3), (11.0, -4.6)):
        s, p = dg.exact_pmf(sigma, c)
        sj, pj = jdg.exact_pmf(sigma, c)
        np.testing.assert_array_equal(s, sj)
        np.testing.assert_allclose(p, pj, rtol=1e-12, atol=0)


def test_cdt_matches_jax():
    cdt = dg.build_cdt(1.7, 0.4, device="cpu")
    cdtj = jdg.build_cdt(1.7, 0.4)
    np.testing.assert_array_equal(cdt["support"].numpy(),
                                  np.asarray(cdtj["support"]))
    np.testing.assert_array_equal(cdt["cdf"].numpy(), np.asarray(cdtj["cdf"]))
    key = jax.random.key(2)
    zj = np.asarray(jdg.sample_cdt(key, cdtj, shape=(20_000,)))
    u = np.array(jax.random.uniform(key, (20_000,),
                                    dtype=cdtj["cdf"].dtype))
    z = dg.sample_cdt(torch.from_numpy(u), cdt).numpy()
    np.testing.assert_array_equal(z, zj)
    assert _tvd(z, 1.7, 0.4) < 0.03


def test_rejection_matches_jax():
    key = jax.random.key(4)
    c = jnp.asarray(np.linspace(-5.0, 5.0, 400))
    sigma, rounds = 1.3, 16
    zj = np.asarray(jdg.sample_dgauss_rejection(key, c, sigma, rounds=rounds))
    # the function's own random numbers, round by round
    normals, uniforms = [], []
    for k in jax.random.split(key, rounds):
        k1, k2 = jax.random.split(k)
        normals.append(np.array(jax.random.normal(k1, c.shape, c.dtype)))
        uniforms.append(np.array(jax.random.uniform(
            k2, c.shape, c.dtype, minval=jnp.finfo(c.dtype).tiny)))
    z = dg.sample_dgauss_rejection(torch.tensor(np.stack(normals)),
                                   torch.tensor(np.stack(uniforms)),
                                   torch.tensor(np.array(c)), sigma)
    np.testing.assert_array_equal(z.numpy(), zj)


def test_inverse_cdf_matches_jax():
    key = jax.random.key(9)
    c = np.linspace(-4.0, 4.0, 300)
    zj = np.asarray(jdg.sample_dgauss_inverse_cdf(key, jnp.asarray(c), 0.8,
                                                  16))
    u = np.array(jax.random.uniform(key, c.shape, dtype=jnp.float64))
    z = dg.sample_dgauss_inverse_cdf(torch.from_numpy(u),
                                     torch.from_numpy(c), 0.8, 16).numpy()
    np.testing.assert_array_equal(z, zj)


def test_theta_helpers_match_jax():
    sig = np.array([0.3, 0.8, 1.0, 2.5, 7.0])
    for c in (0.0, 0.37):
        np.testing.assert_allclose(
            th.log_rho_Z(torch.from_numpy(sig), c).numpy(),
            np.asarray(jth.log_rho_Z(jnp.asarray(sig), c)), rtol=1e-12)
    np.testing.assert_allclose(float(th.rho_Z(1.7)),
                               float(jth.rho_Z(jnp.asarray(1.7))),
                               rtol=1e-12)
    q = np.array([0.1, 0.5, 0.9])
    np.testing.assert_allclose(
        th.jacobi_theta3(0.3, torch.from_numpy(q)).numpy(),
        np.asarray(jth.jacobi_theta3(jnp.asarray(0.3), jnp.asarray(q))),
        rtol=1e-12)
    np.testing.assert_allclose(float(th.log_partition_zn(1.4, 6)),
                               float(jth.log_partition_zn(
                                   jnp.asarray(1.4), 6)), rtol=1e-12)
    cen = np.linspace(-1.0, 1.0, 6)
    np.testing.assert_allclose(
        float(th.log_partition_zn(1.4, 6, torch.from_numpy(cen))),
        float(jth.log_partition_zn(jnp.asarray(1.4), 6, jnp.asarray(cen))),
        rtol=1e-12)
    gs = np.array([1.0, 2.0, 0.5])
    np.testing.assert_allclose(
        float(th.smoothing_parameter_generic(torch.from_numpy(gs), 3)),
        float(jth.smoothing_parameter_generic(jnp.asarray(gs), 3)),
        rtol=1e-12)
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    for center in (None, np.array([0.2, -0.4])):
        cj = None if center is None else jnp.asarray(center)
        ct = None if center is None else torch.from_numpy(center)
        np.testing.assert_allclose(
            float(th.log_riemann_theta(torch.from_numpy(basis), 0.9, ct)),
            float(jth.log_riemann_theta(jnp.asarray(basis), 0.9, cj)),
            rtol=1e-12)
    np.testing.assert_allclose(
        float(th.riemann_theta(torch.from_numpy(basis), 0.9)),
        float(jth.riemann_theta(jnp.asarray(basis), 0.9)), rtol=1e-12)


def test_identity_helpers():
    lat = tid.identity_lattice(5, device="cpu")
    assert lat.meta == {"kind": "identity", "n": 5} and lat.name == "Z^5"
    assert torch.equal(lat.basis, torch.eye(5, dtype=torch.float64))
    assert torch.equal(lat.gs_norms, torch.ones(5, dtype=torch.float64))
    t = torch.tensor([0.5, 1.5, -0.2, 2.7, -2.5])
    np.testing.assert_array_equal(tid.decode_cvp_zn(t).numpy(),
                                  np.asarray(jid.decode_cvp_zn(t.numpy())))
    np.testing.assert_array_equal(tid.successive_minima_zn(4),
                                  jid.successive_minima_zn(4))
    assert tid.kissing_number_zn(7) == jid.kissing_number_zn(7) == 14
    np.testing.assert_allclose(float(tid.theta_series_zn(0.3, 4)),
                               float(jid.theta_series_zn(0.3, 4)),
                               rtol=1e-6)
    checks = tid.validate_identity_lattice(n=4, n_samples=20_000,
                                           device="cpu")
    assert checks["all_passed"], checks
    # decoding on Z^n through the lattice is rounding as well
    np.testing.assert_array_equal(lat.nearest_plane(t).numpy(),
                                  tid.decode_cvp_zn(t).numpy())
