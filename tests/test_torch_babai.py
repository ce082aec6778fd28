"""Babai nearest-plane decoding in the port: the plain version of kernel B7
against `babai_decode_batch_pallas` in interpret mode and against the
float64 row scan, `Lattice.nearest_plane` / `decode_cvp` on one target and
on a batch, and the lattice layer's derived quantities against the JAX
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lattice_gaussian_mcmc_tpu.lattices import base as jbase
from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as jlat
from lattice_gaussian_mcmc_tpu.ops import linalg as jlinalg
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    babai_decode_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.lattices import base as tbase
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops import linalg
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _basis8():
    # the basis of tests/unit/test_klein_pallas.py test_babai_pallas_matches_xla
    rng = np.random.default_rng(42)
    return (np.triu(rng.integers(-3, 4, (8, 8))).astype(float)
            + np.diag([5.0] * 8)), rng


def test_b7_plain_matches_pallas():
    """Equal, target for target (both recentre by round(ct) per target)."""
    B8, rng = _basis8()
    lat = jlat(B8, dtype=jnp.float32)
    pre = klein_precompute(lat, 8.0)
    targets = rng.normal(scale=20.0, size=(256, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        Xp = np.asarray(babai_decode_batch_pallas(
            pre, jnp.asarray(targets), tile=128, interpret=True))
    tl = lattice_from_basis(B8, device="cpu")
    X = tl.nearest_plane(torch.from_numpy(targets.astype(np.float64)))
    assert X.shape == (256, 8) and X.dtype == torch.float64
    np.testing.assert_array_equal(X.numpy(), Xp)


def test_b7_plain_matches_float64_row_scan_n136():
    """n = 136 pads to 256 rows (four 64-row blocks); targets B x* + w."""
    rng = np.random.default_rng(136)
    n = 136
    basis = (np.triu(rng.uniform(-0.5, 0.5, (n, n)), 1)
             + np.diag(rng.uniform(1.0, 2.0, n)))
    lat = lattice_from_basis(basis, device="cpu")
    xs = rng.integers(-2, 3, (64, n)).astype(np.float64)
    t = xs @ basis.T + rng.normal(scale=0.1, size=(64, n))
    t = torch.from_numpy(t)
    X = lat.nearest_plane(t)
    Xr = linalg.babai_nearest_plane(lat.Q, lat.R, t)
    np.testing.assert_array_equal(X.numpy(), Xr.numpy())
    # the row scan is the JAX package's, target for target
    Xj = jax.vmap(lambda tt: jlinalg.babai_nearest_plane(
        jnp.asarray(lat.Q.numpy()), jnp.asarray(lat.R.numpy()), tt))(
            jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(Xr.numpy(), np.asarray(Xj))
    # noise of 0.1 against R_ii >= 1 (5 standard deviations to a decision
    # boundary): every target decodes to x*
    np.testing.assert_array_equal(X.numpy(), xs)
    # the float32 plain version (the kernel's dtype) agrees here too
    ops32 = klein_cuda.babai_operands(lat.Q, lat.R, torch.float32)
    np.testing.assert_array_equal(
        klein_cuda.babai_coeffs(ops32, t).numpy(), X.numpy())


def test_decode_cvp_single_and_batch():
    B8, rng = _basis8()
    lat = lattice_from_basis(B8, device="cpu")
    jl = jlat(B8, dtype=jnp.float64)
    t = rng.normal(scale=10.0, size=(5, 8))
    pts, X = lat.decode_cvp(torch.from_numpy(t))
    assert pts.shape == (5, 8) and X.shape == (5, 8)
    for b in range(5):
        p1, x1 = lat.decode_cvp(torch.from_numpy(t[b]))
        assert p1.shape == (8,) and x1.shape == (8,)
        np.testing.assert_array_equal(x1.numpy(), X[b].numpy())
        pj, xj = jl.decode_cvp(jnp.asarray(t[b]))
        np.testing.assert_array_equal(x1.numpy(), np.asarray(xj))
        np.testing.assert_allclose(p1.numpy(), np.asarray(pj), atol=1e-12)
    pr, xr = linalg.decode_cvp(lat.basis, lat.Q, lat.R, torch.from_numpy(t))
    np.testing.assert_array_equal(xr.numpy(), X.numpy())
    np.testing.assert_allclose(pr.numpy(), pts.numpy(), atol=1e-12)


def test_b7_plain_rounds_half_to_even():
    """basis [[1, .5], [0, 1]] at half-integer targets: every decision is a
    tie, decided half to even after the per-target recentring."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device="cpu")
    h = np.stack(np.meshgrid(np.arange(-6, 7), np.arange(-6, 7)),
                 -1).reshape(-1, 2) / 2.0
    t = torch.from_numpy(h)
    ops = klein_cuda.babai_operands(lat.Q, lat.R, torch.float32)
    ct, k = klein_cuda.babai_centres(ops, t)
    y = klein_cuda.babai_decode_plain(ops, ct)
    # by hand: row 1 then row 0, each rounded half to even, in the
    # recentred frame y = x - k
    c1 = ct[1].double()
    y1 = torch.round(c1)
    y0 = torch.round(ct[0].double() - 0.5 * y1)
    np.testing.assert_array_equal(y[1].numpy(), y1.numpy())
    np.testing.assert_array_equal(y[0].numpy(), y0.numpy())
    assert bool((c1.abs() == 0.5).any())   # ties do occur


def test_lattice_quantities_match_jax():
    rng = np.random.default_rng(3)
    basis = rng.integers(-4, 5, (6, 6)).astype(np.float64) + 6 * np.eye(6)
    lat = lattice_from_basis(basis, device="cpu")
    jl = jlat(basis, dtype=jnp.float64)
    for name in ("min_gs_norm", "max_gs_norm", "log_det"):
        np.testing.assert_allclose(float(getattr(lat, name)),
                                   float(getattr(jl, name)), rtol=1e-12)
    np.testing.assert_allclose(lat.dual_basis().numpy(),
                               np.asarray(jl.dual_basis()), rtol=1e-10,
                               atol=1e-12)
    for fn in ("gaussian_heuristic", "first_minimum_estimate",
               "smoothing_parameter", "covering_radius_bound", "volume"):
        np.testing.assert_allclose(float(getattr(tbase, fn)(lat)),
                                   float(getattr(jbase, fn)(jl)), rtol=1e-10)
    assert tbase.is_integer_basis(lat.basis)
    assert not tbase.is_integer_basis(lat.basis + 0.25)
    X = rng.integers(-3, 4, (7, 6)).astype(np.float64)
    pts = X @ basis.T
    xi, res = tbase.coeffs_from_points(lat, torch.from_numpy(pts))
    np.testing.assert_array_equal(xi.numpy(), X)
    assert float(res) < 1e-9
    x1, _ = tbase.coeffs_from_points(lat, torch.from_numpy(pts[0]))
    np.testing.assert_array_equal(x1.numpy(), X[0])
    np.testing.assert_allclose(linalg.gram_schmidt_norms(basis).numpy(),
                               np.asarray(jlinalg.gram_schmidt_norms(
                                   jnp.asarray(basis))), rtol=1e-10)
    gv = linalg.gram_schmidt_vectors(torch.from_numpy(basis)).numpy()
    np.testing.assert_allclose(gv, np.asarray(jlinalg.gram_schmidt_vectors(
        jnp.asarray(basis))), rtol=1e-8, atol=1e-10)
