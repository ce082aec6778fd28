"""The port's `models/` against the JAX package's on the CPU.

Tolerances: the grid adjacency held exactly; the GMRF and CAR precisions,
the GMRF log density and its gradient to 1e-12; `gmrf_sample` on the JAX
package's own normals to 1e-10 (two Cholesky solves in float64);
`ising_gibbs_sweep` on the uniforms the JAX sweep draws from its split
keys, equal spin for spin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu import models as jm
from lattice_gaussian_mcmc_tpu_torch import models as tm

TOL = 1e-12


@pytest.mark.parametrize("shape,periodic", [((4, 5), False), ((4, 5), True),
                                            ((3, 3, 3), False)])
def test_precisions_equal_jax(shape, periodic):
    np.testing.assert_array_equal(tm.grid_adjacency(shape, periodic),
                                  jm.grid_adjacency(shape, periodic))
    np.testing.assert_allclose(
        tm.gmrf_precision(shape, 1.3, 0.2, periodic, device="cpu").numpy(),
        np.asarray(jm.gmrf_precision(shape, 1.3, 0.2, periodic)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tm.car_precision(shape, 0.4, 2.0, periodic, device="cpu").numpy(),
        np.asarray(jm.car_precision(shape, 0.4, 2.0, periodic)),
        rtol=TOL, atol=TOL)


def test_car_rejects_improper_rho():
    with pytest.raises(ValueError, match="proper CAR"):
        tm.car_precision((3, 3), rho=1.0, device="cpu")


def test_gmrf_log_density_and_gradient_equal_jax():
    from lattice_gaussian_mcmc_tpu.models.gmrf import gmrf_grad_log_density
    from lattice_gaussian_mcmc_tpu_torch.models.gmrf import (
        gmrf_grad_log_density as t_grad,
    )
    rng = np.random.default_rng(0)
    Q = np.array(jm.gmrf_precision((5, 4)))
    x, b = rng.normal(size=20), rng.normal(size=20)
    Qt, xt, bt = (torch.from_numpy(a) for a in (Q, x, b))
    for bb, bj in ((None, None), (bt, jnp.asarray(b))):
        np.testing.assert_allclose(
            float(tm.gmrf_log_density(xt, Qt, bb)),
            float(jm.gmrf_log_density(jnp.asarray(x), jnp.asarray(Q), bj)),
            rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            t_grad(xt, Qt, bb).numpy(),
            np.asarray(gmrf_grad_log_density(jnp.asarray(x), jnp.asarray(Q),
                                             bj)), rtol=TOL, atol=TOL)


def test_gmrf_sample_on_jax_normals():
    key = jax.random.key(3)
    Qj = jm.gmrf_precision((4, 4), 1.0, 0.3)
    n = Qj.shape[0]
    b = np.linspace(-1.0, 1.0, n)
    want = np.asarray(jm.gmrf_sample(key, Qj, jnp.asarray(b), shape=(5,)))
    z = np.array(jax.random.normal(key, (5, n), dtype=Qj.dtype))
    got = tm.gmrf_sample(torch.tensor(np.asarray(Qj)),
                         torch.from_numpy(b), shape=(5,), normals=z)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # the generator path draws the same law's shapes on the CPU
    g = tm.gmrf_sample(torch.tensor(np.asarray(Qj)), shape=(2, 3),
                       generator=torch.Generator().manual_seed(0))
    assert g.shape == (2, 3, n) and bool(torch.isfinite(g).all())


def test_ising_sweeps_equal_jax_on_its_uniforms():
    H, W, beta = 12, 10, 0.45
    rng = np.random.default_rng(1)
    spins0 = np.where(rng.random((H, W)) < 0.5, 1.0, -1.0)
    key = jax.random.key(7)
    js = jnp.asarray(spins0)
    ts = torch.from_numpy(spins0)
    for i in range(5):
        k = jax.random.fold_in(key, i)
        k0, k1 = jax.random.split(k)
        u = tuple(np.array(jax.random.uniform(kk, (H, W),
                                              dtype=jnp.float64))
                  for kk in (k0, k1))
        js = jm.ising_gibbs_sweep(k, js, beta, 1.0, 0.1)
        ts = tm.ising_gibbs_sweep(ts, beta, 1.0, 0.1, uniforms=u)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(tm.ising_energy(ts, 1.0, 0.1)) == pytest.approx(
        float(jm.ising_energy(js, 1.0, 0.1)), abs=TOL)


def test_ising_sample_on_the_cpu():
    spins, energy, mag = tm.ising_sample((16, 16), 0.44, n_sweeps=20,
                                         seed=3, device="cpu")
    assert spins.shape == (16, 16)
    assert set(torch.unique(spins).tolist()) <= {-1.0, 1.0}
    assert float(energy) == float(tm.ising_energy(spins))
    assert -1.0 <= float(mag) <= 1.0
    again = tm.ising_sample((16, 16), 0.44, n_sweeps=20, seed=3,
                            device="cpu")[0]
    assert torch.equal(spins, again)
