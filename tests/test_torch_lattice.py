"""The port's lattice layer against the JAX package: NTRU keygen and the
cached NTRU-512 key, the host float64 QR, q-ary bases, the FALCON table,
the window policy and the Klein precomputation."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lattice_gaussian_mcmc_tpu.lattices.ntru as jntru
from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.lattices.qary import (
    falcon_parameters as j_falcon,
    qary_lattice as j_qary,
)
from lattice_gaussian_mcmc_tpu.ops.theta import (
    smoothing_parameter_zn as j_eta,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu.samplers.klein import (
    suggest_window as j_sw,
    suggest_window_budget as j_swb,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    falcon_parameters,
    lattice_from_basis,
    lattice_from_numpy,
    ntru_keygen,
    ntru_lattice,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    suggest_window,
    suggest_window_budget,
)

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_cache")
# two float64 Householder QRs of the same basis (LAPACK through numpy and
# through XLA) agree to a few ulps times the condition growth
QR_RTOL = 1e-10


@pytest.fixture(scope="module")
def ntru512():
    jlat = jntru.ntru_lattice(512, q=12289, seed=0, cache_dir=CACHE,
                              dtype=jnp.float64)
    lat = ntru_lattice(512, q=12289, seed=0, cache_dir=CACHE, device="cpu")
    return jlat, lat


def test_ntru512_basis_and_gso_match_jax(ntru512):
    jlat, lat = ntru512
    assert lat.n == 1024
    np.testing.assert_array_equal(lat.basis.numpy(), np.asarray(jlat.basis))
    np.testing.assert_allclose(torch.diagonal(lat.R).numpy(),
                               np.diag(np.asarray(jlat.R)), rtol=QR_RTOL)
    np.testing.assert_allclose(lat.gs_norms.numpy(),
                               np.asarray(jlat.gs_norms), rtol=QR_RTOL)


def test_falcon512_window_budget_is_16(ntru512):
    jlat, lat = ntru512
    sigma = falcon_parameters(512)["sigma"]
    assert sigma == 165.7 == j_falcon(512)["sigma"]
    pre = klein_precompute(lat, sigma, tail_budget=0.01)
    assert pre.window == 16
    assert j_pre(jlat, sigma, tail_budget=0.01).window == 16
    assert suggest_window_budget(pre.sigmas.numpy(), 0.01) == 16


def test_keygen_cache_miss_matches_jax():
    """A cache miss runs the copied keygen/NTRUSolve: the same key as the
    JAX package's, and the basis built from it."""
    key = ntru_keygen(16, q=12289, seed=3)
    jkey = jntru.ntru_keygen(16, q=12289, seed=3)
    for k in ("f", "g", "F", "G", "h"):
        np.testing.assert_array_equal(key[k], jkey[k])
    lat = ntru_lattice(16, seed=3, key=key, device="cpu")
    np.testing.assert_array_equal(lat.basis.numpy(),
                                  jntru.ntru_secret_basis(jkey))


@pytest.mark.parametrize("basis", [
    np.array([[2.0, 1.0], [0.0, 3.0]]),
    np.array([[3.0, 1.0], [1.0, 2.0]]),
    np.array([[1.0, 1.0], [1.0, 1.0 + 1e-6]]),
])
def test_host_qr_matches_jax(basis):
    jlat = j_lfb(basis, dtype=jnp.float64)
    lat = lattice_from_basis(basis, device="cpu")
    np.testing.assert_allclose(lat.R.numpy(), np.asarray(jlat.R),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lat.Q.numpy(), np.asarray(jlat.Q),
                               rtol=1e-9, atol=1e-12)
    assert (torch.diagonal(lat.R) > 0).all()


def test_qary_falcon_theta_match_jax():
    np.testing.assert_array_equal(
        qary_lattice(12, 6, 97, seed=2, device="cpu").basis.numpy(),
        np.asarray(j_qary(12, 6, 97, seed=2, dtype=jnp.float64).basis))
    assert falcon_parameters(1024) == j_falcon(1024)
    with pytest.raises(ValueError):
        falcon_parameters(256)
    assert smoothing_parameter_zn(64, 0.01) == j_eta(64, 0.01)


def test_window_policies_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        sig = rng.uniform(0.3, 3.0, size=64)
        b = float(10 ** rng.uniform(-4, -2))
        assert suggest_window_budget(sig, b) == j_swb(sig, b)
    for s in (0.2, 1.0, 2.7, 40.0):
        assert suggest_window(s) == j_sw(s)


def test_precompute_from_numpy_matches_jax_fields():
    basis = np.triu(np.random.default_rng(1).uniform(-1, 1, (6, 6)), 1) \
        + np.diag([2.0, 1.5, 1.0, 2.5, 1.2, 1.8])
    center = np.linspace(-2, 3, 6)
    jlat = j_lfb(basis, dtype=jnp.float64)
    jp = j_pre(jlat, 1.7, center=center)
    lat = lattice_from_numpy({k: np.asarray(getattr(jlat, k))
                              for k in ("basis", "Q", "R", "gs_norms")},
                             device="cpu")
    p = klein_precompute(lat, 1.7, center=center)
    assert p.window == jp.window
    for k in ("U", "cs", "sigmas"):
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-12,
                                   atol=1e-12)


def test_entry_points_need_a_device_without_cuda():
    """With no card, building on the default device raises: the port never
    drops to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lattice_from_basis(np.eye(2))
