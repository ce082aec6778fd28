"""The port's sampler utilities (`samplers/utils.py`), precision dispatch
(`samplers/adaptive.py`) and the sampler API's remainders (`klein_sample`,
`peikert_sample`, `sample_dgauss_with_logz`,
`IMHKSampler.estimate_spectral_gap` / `diagnose_convergence`, the exports)
against the JAX package on the CPU.

Tolerances: host arithmetic that both packages do in float64 the same way
(alias tables, `rho_inverse_radius`, `imhk_mixing_time_bound`) is held
exactly; `discrete_gaussian_moments`, `f32_law_distortion_bound` and the
precision choice to 1e-9 relative; `log_partition_bounds` to 1e-6
relative; the samplers' laws at TVD < 0.02 (the reference's gate) on the
enumerated 2D target; `log_partition_mc` within 3 Monte Carlo standard
errors of the enumerated log rho."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.ops.discrete_gaussian import (
    log_partition_window as j_log_partition_window,
)
from lattice_gaussian_mcmc_tpu.samplers import adaptive as j_adaptive
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu.samplers import utils as j_utils
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    exact_pmf,
    log_partition_window,
    sample_dgauss,
    sample_dgauss_with_logz,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    adaptive,
    adaptive_klein_sample,
    choose_precision,
    f32_law_distortion_bound,
    klein_precomp_from_numpy,
    klein_precompute,
    klein_sample,
    klein_sample_batch,
    peikert_precompute,
    peikert_sample,
    peikert_sample_batch,
    utils,
)
from tests.unit.test_klein import empirical_dist, enumerate_target, tvd_dicts

TVD_GATE = 0.02
SKEW = np.array([[1.0, 0.5], [0.0, 1.0]])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_precomp_numpy(pre):
    return {k: np.asarray(getattr(pre, k)) for k in
            ("basis", "U", "cs", "sigmas", "sigma", "window", "clamped")}


# --- exact host arithmetic -------------------------------------------------


@pytest.mark.parametrize("sigma", [0.8, 2.0, 7.5])
def test_alias_table_equals_jax(sigma):
    _, probs = exact_pmf(sigma)
    j = j_utils.build_alias_table(probs)
    t = utils.build_alias_table(probs, device="cpu")
    np.testing.assert_array_equal(t["prob"].numpy(), np.asarray(j["prob"]))
    np.testing.assert_array_equal(t["alias"].numpy(), np.asarray(j["alias"]))


def test_sample_alias_law():
    """TVD < 0.02 of 200,000 alias draws to the table's pmf."""
    support, probs = exact_pmf(2.0)
    table = utils.build_alias_table(probs, device="cpu")
    g = torch.Generator().manual_seed(5)
    u1 = torch.rand(200_000, generator=g)
    u2 = torch.rand(200_000, generator=g)
    idx = utils.sample_alias(u1, u2, table)
    emp = np.bincount(idx.numpy(), minlength=len(probs)) / idx.numel()
    assert 0.5 * np.abs(emp - probs).sum() < TVD_GATE


@pytest.mark.parametrize("sigma,mass,n", [(2.0, 0.99, 16), (0.7, 0.5, 3),
                                          (5.0, 0.9, 128)])
def test_rho_inverse_radius_and_mixing_bound_equal_jax(sigma, mass, n):
    assert utils.rho_inverse_radius(sigma, mass, n) == \
        j_utils.rho_inverse_radius(sigma, mass, n)
    for delta, eps in ((0.5, 0.25), (1e-3, 0.01), (0.93, 0.1)):
        assert utils.imhk_mixing_time_bound(delta, eps) == \
            j_utils.imhk_mixing_time_bound(delta, eps)


@pytest.mark.parametrize("sigma", [0.6, 3.0, 11.0])
def test_moments_match_jax(sigma):
    """1e-9 relative (the first moment is 0 up to rounding: 1e-12
    absolute)."""
    t = utils.discrete_gaussian_moments(sigma, order=4)
    j = j_utils.discrete_gaussian_moments(sigma, order=4)
    for m in (2, 3, 4):
        assert t[m] == pytest.approx(j[m], rel=1e-9, abs=1e-12)
    assert abs(t[1] - j[1]) < 1e-12


def test_log_partition_bounds_match_jax():
    """1e-6 relative, on a skewed and an integer basis."""
    for basis, sigma in ((SKEW, 1.3), (np.array([[2.0, 1.0], [0.0, 2.0]]),
                                       4.0)):
        lo, hi = utils.log_partition_bounds(
            lattice_from_basis(basis, device="cpu"), sigma)
        jlo, jhi = j_utils.log_partition_bounds(
            j_lfb(basis, dtype=jnp.float64), sigma)
        assert float(lo) == pytest.approx(float(jlo), rel=1e-6)
        assert float(hi) == pytest.approx(float(jhi), rel=1e-6)


def _bases():
    """A well-conditioned basis and an ill-conditioned one (the second's
    f32 bound exceeds 1e-2), so that both precision choices occur."""
    rng = np.random.default_rng(11)
    good = np.triu(rng.uniform(-0.2, 0.2, (24, 24)), 1) + np.eye(24) * 2.0
    bad = np.triu(rng.uniform(-40.0, 40.0, (24, 24)), 1) + np.diag(
        np.geomspace(0.05, 1.0, 24))
    return ((good, 1.5, "f32"), (bad, 0.4, "f64"))


@pytest.mark.parametrize("case", [0, 1])
def test_distortion_bound_and_choice_match_jax(case):
    """The bound to 1e-9 relative on the same precomputation, and the same
    choice (f32 for the well-conditioned basis, f64 for the other)."""
    basis, sigma, want = _bases()[case]
    jp = j_pre(j_lfb(basis, dtype=jnp.float64), sigma)
    pre = klein_precomp_from_numpy(_jax_precomp_numpy(jp), device="cpu")
    b = f32_law_distortion_bound(pre)
    assert b == pytest.approx(j_adaptive.f32_law_distortion_bound(jp),
                              rel=1e-9)
    assert choose_precision(pre) == j_adaptive.choose_precision(jp) == want


def test_adaptive_klein_sample_paths():
    """On the CPU the f32 choice runs B1's plain version in float32, the
    f64 choice the float64 per-row draw; info keeps the bound and rtol."""
    good, s_good, _ = _bases()[0]
    X, lw, info = adaptive_klein_sample(
        lattice_from_basis(good, device="cpu"), s_good, 64, seed=3)
    assert info["path"] == "plain_f32" and X.dtype == torch.float32
    assert info["rtol"] == 1e-2 and info["f32_distortion_bound"] <= 1e-2
    assert X.shape == (64, 24) and torch.isfinite(lw).all()
    bad, s_bad, _ = _bases()[1]
    lat = lattice_from_basis(bad, device="cpu")
    X, lw, info = adaptive_klein_sample(lat, s_bad, 64, seed=3)
    assert info["path"] == "plain_f64" and X.dtype == torch.float64
    assert info["f32_distortion_bound"] > 1e-2
    X64, _ = klein_sample_batch(klein_precompute(lat, s_bad), 64, seed=3)
    torch.testing.assert_close(X, X64, rtol=0, atol=0)
    # a float32 lattice escalates to float64 as well
    lat32 = lattice_from_basis(bad, dtype=torch.float32, device="cpu")
    X, _, info = adaptive_klein_sample(lat32, s_bad, 8, seed=3)
    assert info["path"] == "plain_f64" and X.dtype == torch.float64


# --- the sampler API's remainders -----------------------------------------


def test_sample_dgauss_with_logz_matches_log_partition_window():
    """log Z equals `log_partition_window` (and the JAX function's) to
    1e-12; z is `sample_dgauss`'s draw on the same uniforms."""
    g = torch.Generator().manual_seed(2)
    c = torch.randn(500, generator=g, dtype=torch.float64) * 3
    s = torch.rand(500, generator=g, dtype=torch.float64) + 0.3
    u = torch.rand(500, 32, generator=g, dtype=torch.float64)
    z, lz = sample_dgauss_with_logz(u, c, s, 32)
    torch.testing.assert_close(z, sample_dgauss(u, c, s, 32), rtol=0, atol=0)
    torch.testing.assert_close(lz, log_partition_window(c, s, 32), rtol=0,
                               atol=1e-12)
    jl = np.asarray(j_log_partition_window(jnp.asarray(c.numpy()),
                                           jnp.asarray(s.numpy()), 32))
    np.testing.assert_allclose(lz.numpy(), jl, rtol=0, atol=1e-12)


def test_klein_sample_is_a_row_of_the_batch():
    """Chain c of `klein_sample` equals row c of `klein_sample_batch` at the
    same seed and step, bit for bit."""
    pre = klein_precompute(lattice_from_basis(SKEW, device="cpu"), 1.1)
    X, lw = klein_sample_batch(pre, 40, seed=9, step=3)
    for c in (0, 7, 39):
        x, w = klein_sample(pre, seed=9, step=3, chain=c)
        torch.testing.assert_close(x, X[c], rtol=0, atol=0)
        torch.testing.assert_close(w, lw[c], rtol=0, atol=0)


def test_peikert_sample_is_a_row_of_the_batch():
    lat = lattice_from_basis(np.diag([1.0, 2.0, 1.5]), device="cpu")
    pre = peikert_precompute(lat, 12.0)
    X = peikert_sample_batch(pre, 20, seed=4)
    for c in (0, 13):
        torch.testing.assert_close(peikert_sample(pre, seed=4, chain=c),
                                   X[c], rtol=0, atol=0)


def test_klein_batch_law_2d():
    """The law `klein_sample` draws from (its rows): TVD < 0.02 on the
    enumerated 2D target."""
    pre = klein_precompute(lattice_from_basis(SKEW, device="cpu"), 2.0)
    X, _ = klein_sample_batch(pre, 100_000, seed=1)
    target = enumerate_target(SKEW, 2.0, np.zeros(2), radius=15)
    assert tvd_dicts(empirical_dist(X.numpy()), target) < TVD_GATE


def test_sample_coset_law_2d():
    """Points of Lambda + c, and their law D_{Lambda + c, sigma} at
    TVD < 0.02 (coefficients k of x = B k + c against the enumerated
    rho(B k + c))."""
    lat = lattice_from_basis(SKEW, device="cpu")
    shift = np.array([0.5, 0.25])
    pts = utils.sample_coset(lat, 1.7, shift, 100_000, seed=6)
    k = np.linalg.solve(SKEW, (pts.numpy() - shift).T).T
    np.testing.assert_allclose(k, np.rint(k), atol=1e-9)
    target = enumerate_target(SKEW, 1.7, -shift, radius=15)
    assert tvd_dicts(empirical_dist(np.rint(k)), target) < TVD_GATE


def test_sample_ellipsoidal_law_2d():
    """Integer coefficients k with weight exp(-1/2 (B k)^T Sigma^-1 B k):
    TVD < 0.02 to the enumerated law."""
    lat = lattice_from_basis(SKEW, device="cpu")
    Sigma = np.array([[4.0, 1.0], [1.0, 2.0]])
    pts = utils.sample_ellipsoidal(lat, Sigma, 100_000, seed=8)
    k = np.rint(np.linalg.solve(SKEW, pts.numpy().T).T)
    r = 15
    grid = np.array([(a, b) for a in range(-r, r + 1)
                     for b in range(-r, r + 1)], dtype=np.float64)
    x = grid @ SKEW.T
    lp = -0.5 * np.einsum("ij,jk,ik->i", x, np.linalg.inv(Sigma), x)
    p = np.exp(lp - lp.max())
    p /= p.sum()
    target = {tuple(map(int, g)): q for g, q in zip(grid, p)}
    assert tvd_dicts(empirical_dist(k), target) < TVD_GATE


def test_log_partition_mc_within_three_standard_errors():
    """At sigma 0.45 the Klein weights vary, so the estimate has a standard
    error; it lies within 3 of them of the enumerated log rho."""
    lat = lattice_from_basis(SKEW, device="cpu")
    sigma, n = 0.45, 20_000
    est = float(utils.log_partition_mc(lat, sigma, n, seed=2))
    pre = klein_precompute(lat, sigma, window=64)
    _, lw = klein_sample_batch(pre, n, seed=2)
    w = np.exp(lw.numpy() - lw.numpy().max())
    se = w.std() / (w.mean() * math.sqrt(n))
    grid = np.array([(a, b) for a in range(-12, 13) for b in range(-12, 13)],
                    dtype=np.float64) @ SKEW.T
    exact = np.log(np.exp(-0.5 * (grid ** 2).sum(1) / sigma ** 2).sum())
    assert se > 1e-4
    assert abs(est - exact) < 3 * se


def test_imhk_sampler_gap_and_diagnosis():
    """`estimate_spectral_gap` is `spectral_gap_mc` of the plain per-row
    draw at the seed; `diagnose_convergence` runs `sample` (B1 start, B2
    burn-in, B3 trajectory: their plain versions here)."""
    from lattice_gaussian_mcmc_tpu_torch.samplers import spectral_gap_mc
    lat = lattice_from_basis(SKEW, device="cpu")
    s = IMHKSampler(lat, 0.8, device="cpu")
    _, lw = klein_sample_batch(s.pre, 300, seed=4)
    assert s.estimate_spectral_gap(4, 300) == float(spectral_gap_mc(lw))
    d = s.diagnose_convergence(5, 400)
    assert 0 < d["acceptance_rate"] <= 1
    assert 0 < d["spectral_gap_estimate"] <= 1
    assert d["empirical_mean"].shape == (2,)
    assert d["empirical_std"].shape == (2,)
    torch.testing.assert_close(d["theoretical_std"],
                               torch.full((2,), 0.8, dtype=torch.float64))
    assert d["samples_per_second"] > 0


def test_exports_match_the_jax_names():
    import lattice_gaussian_mcmc_tpu as lg
    import lattice_gaussian_mcmc_tpu.lattices as jl
    import lattice_gaussian_mcmc_tpu.samplers as js
    import lattice_gaussian_mcmc_tpu_torch as lt
    import lattice_gaussian_mcmc_tpu_torch.lattices as tl
    import lattice_gaussian_mcmc_tpu_torch.samplers as ts
    for name in ("klein_sample", "imhk_chain"):
        assert hasattr(lg, name) and hasattr(lt, name)
    assert hasattr(jl, "identity_lattice") and hasattr(tl, "identity_lattice")
    for name in ("adaptive_klein_sample", "choose_precision",
                 "f32_law_distortion_bound", "klein_sample",
                 "peikert_sample"):
        assert hasattr(js, name) and hasattr(ts, name), name
    assert adaptive.adaptive_klein_sample is adaptive_klein_sample
