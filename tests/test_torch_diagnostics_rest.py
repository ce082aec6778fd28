"""The port's convergence, spectral, stats and report diagnostics against
the JAX package's on the same float64 arrays, to 1e-10. The key-driven
functions are held on the same random inputs: sliced Wasserstein on the
JAX key's projections, k-means from the JAX key's initial centres, the
transition gap on the same labels; their seeded entry points are checked
for range and determinism. The report functions that run chains are held
on the port's chains, each side reducing the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.diagnostics import convergence as jc
from lattice_gaussian_mcmc_tpu.diagnostics import report as jrep
from lattice_gaussian_mcmc_tpu.diagnostics import spectral as jsp
from lattice_gaussian_mcmc_tpu.utils import stats as jst
from lattice_gaussian_mcmc_tpu_torch.diagnostics import convergence as tc
from lattice_gaussian_mcmc_tpu_torch.diagnostics import report as trep
from lattice_gaussian_mcmc_tpu_torch.diagnostics import spectral as tsp
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.utils import stats as tst

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_stats_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 7)) * 30
    b = rng.uniform(0.0, 2.0, size=(5, 7))
    for axis in (None, 0, 1):
        _close(tst.logsumexp(_t(a), axis=axis), jst.logsumexp(a, axis=axis))
        _close(tst.logmeanexp(_t(a), axis=axis),
               jst.logmeanexp(jnp.asarray(a), axis=axis))
        _close(tst.logsumexp(_t(a), axis=axis, b=_t(b)),
               jst.logsumexp(a, axis=axis, b=b))
    _close(tst.logsumexp(_t(a), axis=1, keepdims=True),
           jst.logsumexp(a, axis=1, keepdims=True))
    _close(tst.log_softmax(_t(a)), jst.log_softmax(a))
    _close(tst.softmax(_t(a), axis=0), jst.softmax(a, axis=0))


def test_convergence_metrics_equal_the_jax_packages():
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=3000), rng.normal(0.1, 1.2, size=3000)
    _close(tc.tvd_histogram(_t(x), _t(y), 64),
           jc.tvd_histogram(jnp.asarray(x), jnp.asarray(y), 64))
    _close(tc.tvd_histogram(_t(x), _t(y), 16, lo=-1.0, hi=1.0),
           jc.tvd_histogram(jnp.asarray(x), jnp.asarray(y), 16, lo=-1.0,
                            hi=1.0))
    _close(tc.wasserstein_1d(_t(x), _t(y)), jc.wasserstein_1d(x, y))
    _close(tc.batch_means_variance(_t(x)), jc.batch_means_variance(x))
    _close(tc.batch_means_variance(_t(x), 16),
           jc.batch_means_variance(x, 16))
    for a, b in ((x, y), (x, x[::-1].copy()), (x[:500], y)):
        d_t, p_t = tc.ks_2sample(_t(a), _t(b))
        d_j, p_j = jc.ks_2sample(jnp.asarray(a), jnp.asarray(b))
        _close(d_t, d_j)
        _close(p_t, p_j)
    chains = rng.normal(size=(4, 500, 3)) + rng.normal(size=(4, 1, 3))
    _close(tc.gelman_rubin(_t(chains)), jc.gelman_rubin(jnp.asarray(chains)))
    _close(tc.gelman_rubin(_t(chains[..., 0])),
           jc.gelman_rubin(jnp.asarray(chains[..., 0])))
    tvds = np.array([0.5, 0.3, 0.2, 0.3, 0.1, 0.05, 0.04])
    for th in (0.25, 0.1, 0.01):
        assert tc.mixing_time_from_tvd(_t(tvds), th) == \
            jc.mixing_time_from_tvd(tvds, th)


def test_exact_support_metrics_equal_the_jax_packages():
    rng = np.random.default_rng(3)
    z = np.round(rng.normal(0.0, 3.0, size=5000))
    support = np.arange(-12, 13)
    p = np.exp(-0.5 * (support / 3.0) ** 2)
    p /= p.sum()
    _close(tc.tvd_vs_exact(_t(z), support, p),
           jc.tvd_vs_exact(z, support, p))
    _close(tc.kl_divergence_discrete(_t(z), support, p),
           jc.kl_divergence_discrete(z, support, p))
    a = np.round(rng.normal(size=(800, 2)))
    b = np.round(rng.normal(size=(700, 2)))
    _close(tc.tvd_discrete(_t(a), _t(b)), jc.tvd_discrete(a, b))


def test_key_driven_metrics_on_the_same_draws():
    rng = np.random.default_rng(4)
    X, Y = rng.normal(size=(600, 3)), rng.normal(0.2, 1.0, size=(600, 3))
    key = jax.random.key(7)
    dirs = jax.random.normal(key, (32, 3), dtype=jnp.float64)
    _close(tc._sliced_w1(_t(X), _t(Y), _t(np.asarray(dirs))),
           jc.sliced_wasserstein(key, jnp.asarray(X), jnp.asarray(Y)))
    sw = tc.sliced_wasserstein(11, _t(X), _t(Y), 64)
    assert float(sw) == float(tc.sliced_wasserstein(11, _t(X), _t(Y), 64))
    assert 0.0 < float(sw) < 1.0
    # k-means from the JAX key's initial centres, and the transition gap of
    # the same labels
    chain = np.cumsum(rng.normal(size=(2000, 2)), axis=0) * 0.1
    k = 8
    idx = jax.random.choice(jax.random.key(5), chain.shape[0], (k,),
                            replace=False)
    labels_j, centers_j = jsp.kmeans_discretize(jax.random.key(5),
                                                jnp.asarray(chain), k=k)
    labels_t, centers_t = tsp._lloyd(_t(chain), _t(chain[np.asarray(idx)]),
                                     25)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    _close(centers_t, centers_j)
    P_j = np.asarray(jsp._transition_matrix(labels_j, k))
    _close(tsp._transition_matrix(labels_t, k), P_j)
    eigs = np.sort(np.abs(np.linalg.eigvals(P_j)))[::-1]
    _close(tsp._transition_gap(labels_t, k), 1.0 - eigs[1])
    gap = tsp.empirical_transition_gap(3, _t(chain), k=k)
    assert gap == tsp.empirical_transition_gap(3, _t(chain), k=k)
    assert 0.0 <= gap <= 1.0
    _close(tsp.triangular_structure_analysis(_t(P_j))["asymmetry"],
           jsp.triangular_structure_analysis(P_j)["asymmetry"])


def test_spectral_functions_equal_the_jax_packages():
    rng = np.random.default_rng(5)
    lw = rng.normal(size=4000) * 0.3
    sig = rng.uniform(0.3, 3.0, size=16)
    _close(tsp.spectral_gap_mc(_t(lw)), jsp.spectral_gap_mc(lw))
    _close(tsp.spectral_gap_theoretical(_t(lw), _t(sig)),
           jsp.spectral_gap_theoretical(jnp.asarray(lw), jnp.asarray(sig)))
    for d in (0.5, 1e-3, 0.0):
        assert tsp.mixing_time_bounds(d) == jsp.mixing_time_bounds(d)
    _close(tsp.rejection_spectrum(3.0), jsp.rejection_spectrum(3.0))
    _close(tsp.optimal_omega(_t(lw)), jsp.optimal_omega(lw))
    got = tsp.transition_decomposition(_t(lw[:500]))
    want = jsp.transition_decomposition(jnp.asarray(lw[:500]))
    for k in want:
        _close(got[k], want[k])


def test_report_functions_on_the_ports_chains():
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cpu")
    pre = klein_precompute(lat, 0.35)
    X, lw = klein_sample_batch(pre, 3000, seed=1)
    rng = np.random.default_rng(6)
    chains = np.cumsum(rng.normal(size=(3, 400)), axis=1)
    for fn in ("importance_weight_report",):
        got = getattr(trep, fn)(lw)
        want = getattr(jrep, fn)(jnp.asarray(lw.numpy()))
        for k in want:
            _close(got[k], want[k])
    _close(trep.minorization_constant(lw),
           jrep.minorization_constant(jnp.asarray(lw.numpy())))
    assert trep.empirical_mixing_time(_t(chains)) == \
        jrep.empirical_mixing_time(chains)
    pts = rng.normal(size=(200, 4)) * 2.0
    for k, v in jrep.distance_to_mode(pts, np.zeros(4), 2.0).items():
        _close(trep.distance_to_mode(_t(pts), torch.zeros(4), 2.0)[k], v)
    gs = np.array([3.0, 2.0, 1.0, 0.5, 0.25])
    coeffs = rng.normal(size=(500, 5)) * (2.0 / gs)
    got = trep.gs_decay_correlation(_t(coeffs), _t(gs), 2.0)
    want = jrep.gs_decay_correlation(coeffs, gs, 2.0)
    for k in want:
        _close(got[k], want[k])
    x = _t(chains[0])
    assert trep.optimal_batch_size(x) == \
        jrep.optimal_batch_size(jnp.asarray(chains[0]))
    erg = trep.uniform_ergodicity_test(pre, 3, n_starts=3, n_steps=200)
    assert 0.0 <= erg["max_pairwise_tvd"] <= 1.0
    rep = trep.comprehensive_report(pre, 4, n_samples=300, n_chains=2)
    assert rep["ess"] > 0 and 0 < rep["minorization_delta"] <= 1
    assert X.shape == (3000, 2)
