"""The port's CVP-decoding experiment against the JAX package's: the same
LLL-reduced channel lattices from the same numpy seed, the same Babai
decodes on the same targets (float64 on both sides), the MHK decoder's
per-target log-weights, and the experiment's four gates at the
configuration of the JAX package's decoding test
(`tests/unit/test_experiments.py`)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import decoding as jdec
from lattice_gaussian_mcmc_tpu.samplers.klein import (
    klein_log_weight as jax_log_weight,
)
from lattice_gaussian_mcmc_tpu.samplers.klein import (
    klein_precompute as jax_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.experiments import decoding as tdec
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    klein_log_weight,
    klein_precompute,
)

SEED = 42
# per-target log-weights: float64 sums of 32 log-normalisers
LW_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _targets(rng, lat_basis, n, rho, min_gs, count=24):
    xs = rng.integers(-2, 3, size=(count, n)).astype(np.float64)
    w = rng.normal(scale=rho * min_gs, size=(count, n))
    return xs, xs @ lat_basis.T + w


@pytest.mark.parametrize("n", [16, 32])
def test_channel_lattice_and_babai_equal_the_jax_packages(n):
    rt, rj = np.random.default_rng(SEED), np.random.default_rng(SEED)
    lat = tdec._channel_lattice(rt, n, device="cpu")
    jlat = jdec._channel_lattice(rj, n, jnp.float64)
    basis = lat.basis.numpy()
    np.testing.assert_array_equal(basis, np.asarray(jlat.basis))
    min_gs = float(lat.gs_norms.min())
    for rho in (0.05, 0.3, 0.5):
        xs, t = _targets(rt, basis, n, rho, min_gs)
        xs_j, t_j = _targets(rj, basis, n, rho, min_gs)
        np.testing.assert_array_equal(t, t_j)
        got = lat.nearest_plane(torch.from_numpy(t)).numpy()
        want = np.asarray(jdec._babai_batch(jlat, jnp.asarray(t)))
        np.testing.assert_array_equal(got, want)
        assert np.mean(np.all(got == xs, axis=1)) == \
            np.mean(np.all(want == xs, axis=1))


def test_mhk_per_target_log_weights_equal_the_jax_packages():
    rng = np.random.default_rng(SEED)
    n = 16
    lat = tdec._channel_lattice(rng, n, device="cpu")
    jlat = jdec._channel_lattice(np.random.default_rng(SEED), n, jnp.float64)
    min_gs = float(lat.gs_norms.min())
    _, t = _targets(rng, lat.basis.numpy(), n, 0.3, min_gs, count=8)
    sigma = 0.35 * min_gs
    pre = klein_precompute(lat, sigma, window=tdec.MHK_WINDOW)
    tt = torch.from_numpy(t)
    cs_t = (tt @ lat.Q) / torch.diagonal(lat.R)
    x0 = lat.nearest_plane(tt)
    got = klein_log_weight(x0, dataclasses.replace(pre, cs=cs_t))
    jpre = jax_precompute(jlat, sigma, window=tdec.MHK_WINDOW)
    r = np.diag(np.asarray(jlat.R))
    for i in range(len(t)):
        cs_i = np.asarray(jlat.Q).T @ t[i] / r
        want = jax_log_weight(jnp.asarray(x0[i].numpy()),
                              jpre.replace(cs=jnp.asarray(cs_i)))
        np.testing.assert_allclose(float(got[i]), float(want), rtol=LW_TOL,
                                   atol=LW_TOL)
    bx, bd = tdec._mhk_decode_batch(7, lat, tt, sigma, n_steps=16,
                                    window=tdec.MHK_WINDOW)
    d0 = ((x0 @ lat.basis.T - tt) ** 2).sum(dim=1)
    assert bool((bd <= d0).all()) and bx.shape == (8, n)


def test_run_decoding_passes_the_jax_tests_gates(tmp_path):
    cfg = tdec.DecodingConfig(output_dir=str(tmp_path), dimensions=(16, 32),
                              n_targets=24, rho_grid=(0.05, 0.3, 0.5),
                              gibbs_sweeps=24, gibbs_chains=12, mhk_steps=64)
    out = tdec.run_decoding(cfg, device="cpu")
    assert out["all_passed"] is True, out["gates"]
    assert out["backend"] == "cpu"
    assert os.path.exists(tmp_path / "decoding_results.json")
    assert os.path.exists(tmp_path / "decoding_success.png")
    for m in ("babai", "gibbs", "mhk"):
        by_rho = {}
        for r in out["rows"]:
            by_rho.setdefault(r["rho"], []).append(r[f"success_{m}"])
        rhos = sorted(by_rho)
        assert np.mean(by_rho[rhos[0]]) >= np.mean(by_rho[rhos[-1]])
