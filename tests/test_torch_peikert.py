"""Peikert's sampler on the CPU: the precomputation on the cached NTRU-512
key against the JAX package's, kernel B5's plain version against the
Pallas kernel (interpret mode) on the same host normals and uniforms, and
the law of the port's draws (second moments against the analytic
covariance), including n = 136, where the Pallas kernel's own Box-Muller
would write past the end of its normals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.lattices import ntru_lattice as j_ntru
from lattice_gaussian_mcmc_tpu.ops.kernels.peikert_pallas import (
    peikert_rounds_pallas,
    peikert_sample_batch_pallas,
    suggest_peikert_window as j_window,
)
from lattice_gaussian_mcmc_tpu.samplers.peikert import (
    peikert_precompute as j_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    ntru_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    PeikertSampler,
    peikert_precomp_from_numpy,
    peikert_precompute,
    peikert_sample_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 136, 256
# share of coordinates a float32 CDF-boundary tie may flip between the
# Pallas kernel (bf16-split dots, CDF as a matrix product) and the port
# (FP32 products, sequential CDF); rows are independent, so a tie moves
# one coordinate, by one
MAX_TIE_COORDS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n, seed=0, sigma_mult=3.0, noise=0.5):
    """The JAX tests' lattice: B = I + upper-triangular noise, sigma a
    multiple of s1(B); both packages' precomputations."""
    rng = np.random.default_rng(seed)
    basis = np.triu(rng.uniform(-noise, noise, (n, n))) + np.eye(n)
    s1 = float(np.linalg.norm(basis, 2))
    jpre = j_precompute(j_lfb(basis, dtype=jnp.float64), sigma_mult * s1)
    d = {k: np.asarray(getattr(jpre, k))
         for k in ("basis", "L2", "cprime", "r", "sigma")}
    d["window"] = jpre.window
    return basis, jpre, peikert_precomp_from_numpy(d, device="cpu")


def _to_port_rows(a, n, n_pad, n_rounds):
    """Pallas host rows (n_rounds * n, B) -> the port's (n_rounds * n_pad,
    B), zero rows for the padding of each round."""
    out = np.zeros((n_rounds * n_pad, a.shape[1]), np.float32)
    for k in range(n_rounds):
        out[k * n_pad:k * n_pad + n] = a[k * n:(k + 1) * n]
    return torch.from_numpy(out)


def _assert_ties(got, want):
    diff = got != want
    assert diff.mean() <= MAX_TIE_COORDS, diff.sum()
    np.testing.assert_array_equal(np.abs(got - want)[diff], 1.0)


def test_precompute_on_ntru512_matches_jax():
    jlat = j_ntru(512, q=12289, seed=0,
                  cache_dir=os.path.join(REPO, "bench_cache"),
                  dtype=jnp.float64)
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cpu")
    s1 = float(np.linalg.norm(lat.basis.numpy(), 2))
    r = smoothing_parameter_zn(1024, 0.01)
    sigma = 1.05 * r * s1
    jpre = j_precompute(jlat, sigma)
    pre = peikert_precompute(lat, sigma)
    np.testing.assert_allclose(pre.L2.numpy(), np.asarray(jpre.L2),
                               rtol=0, atol=1e-9 * sigma)
    assert float(pre.r) == pytest.approx(float(jpre.r), rel=1e-15)
    w = peikert_cuda.suggest_peikert_window(float(pre.r), 1024)
    assert w == j_window(float(jpre.r), 1024) == 24


@pytest.mark.parametrize("n_rounds", [1, 2])
def test_b5_plain_matches_pallas_on_host_randomness(n_rounds):
    # small couplings keep |c| of order 10, where a float32 ulp is 1e-6
    _, jpre, pre = _setup(N, seed=3, noise=0.02)
    w = peikert_cuda.suggest_peikert_window(float(pre.r), N)
    key = jax.random.key(40 + n_rounds)
    if n_rounds == 1:
        Xp = np.asarray(peikert_sample_batch_pallas(
            key, jpre, B, window=w, tile=128, interpret=True,
            host_rng=True))[None]
    else:
        Xp = np.asarray(peikert_rounds_pallas(
            key, jpre, B, n_rounds=n_rounds, window=w, tile=128,
            interpret=True, host_rng=True))
    # the wrappers' own host randomness (peikert_pallas.py :243-251, :303)
    _, k_z, k_u = jax.random.split(key, 3)
    zin = np.array(jax.random.normal(k_z, (n_rounds * N, B), jnp.float32))
    unif = np.array(jax.random.uniform(k_u, (n_rounds * N, B), jnp.float32))
    ops = peikert_cuda.peikert_operands(pre, window=w)
    assert ops.n_pad == 192
    ring = peikert_cuda.peikert_rounds(
        ops, B, n_rounds, normals=_to_port_rows(zin, N, ops.n_pad, n_rounds),
        uniforms=_to_port_rows(unif, N, ops.n_pad, n_rounds))
    X = peikert_cuda.ring_coeffs(ops, ring).numpy()
    assert X.shape == (n_rounds, B, N)
    _assert_ties(X, Xp)


def test_philox_normals_fill_every_row():
    """Box-Muller in whole pairs over the padded rows: n_pad = 192 for
    n = 136 (hazard C1 of the Pallas kernel is n padded to 8 mod 16)."""
    z = peikert_cuda.philox_normals(5, torch.arange(4096), 0, 192)
    assert z.shape == (192, 4096) and bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.01
    # rows 2p and 2p + 1 are one pair's cos and sin: uncorrelated
    c = float((z[0::2] * z[1::2]).mean())
    assert abs(c) < 0.01


@pytest.mark.parametrize("n", [16, N])
def test_sampler_second_moments(n):
    """PeikertSampler (B5's plain version, in-kernel-style Philox) and the
    Gumbel-max `peikert_sample_batch` against the analytic covariance
    sigma^2 (B^T B)^{-1}."""
    basis, _, _ = _setup(n)
    s1 = float(np.linalg.norm(basis, 2))
    lat = lattice_from_basis(basis, device="cpu")
    samp = PeikertSampler(lat, 3.0 * s1, device="cpu")
    assert samp.operands.window == peikert_cuda.suggest_peikert_window(
        float(samp.pre.r), n)
    Bn = 8192
    target = np.diag(samp.sigma ** 2 * np.linalg.inv(basis.T @ basis))
    se = np.sqrt(target / Bn)
    for X in (samp.sample(7, Bn, return_coeffs=True).numpy(),
              peikert_sample_batch(samp.pre, Bn, seed=7).numpy()):
        assert X.shape == (Bn, n) and np.all(X == np.round(X))
        assert np.all(np.abs(X.mean(0)) < 5 * se)
        ratio = X.var(axis=0, ddof=1) / target
        # chi^2 concentration at 8192 draws: 5 sigma ~ 0.08
        assert np.all(np.abs(ratio - 1.0) < 0.12), ratio
    pts = samp.sample(7, 64)
    torch.testing.assert_close(
        pts, samp.sample(7, 64, return_coeffs=True).double() @ lat.basis.T)


def test_sampler_checks_sigma_and_backend():
    basis, _, _ = _setup(16)
    s1 = float(np.linalg.norm(basis, 2))
    lat = lattice_from_basis(basis, device="cpu")
    with pytest.raises(ValueError, match="s1"):
        PeikertSampler(lat, 0.5 * s1, device="cpu")
    samp = PeikertSampler(lat, 3.0 * s1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        samp.sample(0, 8, backend="cuda")
