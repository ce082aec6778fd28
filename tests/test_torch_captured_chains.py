"""The plain chains on the step driver of `utils/graphs.py`, on the CPU.

- The Philox step read from a device counter (a one-element int64 tensor)
  gives the int step's words, word for word.
- `imhk_chains` (`_run_chains`), `smk_chains`, `gibbs_chain`,
  `annealed_gibbs_decode` (its best points by `torch.where`) and
  `_mhk_decode_batch` equal the eager code they replaced bit for bit at
  fixed seeds. Each runs on two routes: the CPU's eager steps, and the
  captured route's data movement without the capture (static copies of the
  state, `graphs.step_in_place` a step: what a `StepGraph` records). The
  capture itself needs a card: `tests/test_torch_cuda_kernels.py` holds
  the replayed graphs to the eager run there.
- They still match the JAX package's chains at the tolerances of the
  existing tests (the enumerated 2D laws and acceptance, exact decodes).
- Hazard C15's predicate: operands whose predicted |y| reaches 2^24 raise
  before a launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import decoding as jdec
from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu.samplers.gibbs import (
    annealed_gibbs_decode as j_anneal,
)
from lattice_gaussian_mcmc_tpu.samplers.gibbs import gibbs_chain as j_gibbs
from lattice_gaussian_mcmc_tpu.samplers.imhk import imhk_chains as j_imhk
from lattice_gaussian_mcmc_tpu.samplers.imhk import smk_chain as j_smk
from lattice_gaussian_mcmc_tpu_torch.experiments import decoding as tdec
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.lattices.base import smoothing_parameter
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    sample_dgauss_inverse_cdf,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    ChainState,
    annealed_gibbs_decode,
    gibbs_chain,
    imhk_chain,
    imhk_chains,
    imhk_init,
    klein_log_density,
    klein_log_weight,
    klein_precompute,
    klein_sample_batch,
    smk_chains,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import _accept_uniform
from lattice_gaussian_mcmc_tpu_torch.utils import graphs
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    TAG_GIBBS,
    TAG_ROW,
    chain_ids,
    philox_uniform,
    philox_words,
)
from tests.unit.test_klein import empirical_dist, enumerate_target, tvd_dicts

BASIS_2D = np.array([[1.0, 0.5], [0.0, 1.0]])
HARD_SIGMA = 0.35
HARD_ACCEPTANCE = 0.9904      # enumerated stationary acceptance
ACCEPTANCE_TOL = 0.005        # tests/test_torch_trajectory.py's
TVD_GATE = 0.02               # the reference's quality gate
GIBBS_JAX_TVD_GATE = 0.05     # tests/unit/test_peikert_gibbs.py's (one chain)
ROUTES = ("eager", "static_buffers")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StaticBufferSteps:
    """A `StepGraph`'s data movement on the CPU, without the capture: the
    state copied into static buffers, the counter a tensor advanced in
    place, `graphs.step_in_place` a step."""

    def __init__(self, body, state, step=0):
        self.body = body
        self.state = tuple(t.clone() for t in state)
        self.step = torch.full((1,), step, dtype=torch.int64)

    def replay(self, k=1):
        for _ in range(k):
            graphs.step_in_place(self.body, self.step, self.state)


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "static_buffers":
        monkeypatch.setattr(graphs, "stepper", StaticBufferSteps)
    return request.param


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The eager code the driver replaced (the port's samplers before it).
# ---------------------------------------------------------------------------


def _eager_imhk_step(state, pre, seed, chain_offset):
    B = state.coeffs.shape[0]
    step = state.steps + 1
    y, log_w_y = klein_sample_batch(pre, B, seed=seed, step=step,
                                    chain_offset=chain_offset)
    u = _accept_uniform(seed, B, chain_offset, step, state.log_w.dtype,
                        pre.device)
    accept = torch.log(u) < (log_w_y - state.log_w)
    return ChainState(coeffs=torch.where(accept[:, None], y, state.coeffs),
                      log_w=torch.where(accept, log_w_y, state.log_w),
                      accepted=state.accepted + accept.to(torch.int32),
                      steps=step)


def _eager_smk_step(state, pre, Q, R, seed, chain_offset):
    B = state.coeffs.shape[0]
    step = state.steps + 1
    r_diag = torch.diagonal(R).to(pre.U.dtype)
    x = state.coeffs.to(pre.U.dtype)

    def centres(c):
        return (c.to(pre.basis.dtype) @ pre.basis.T) @ Q / r_diag

    cs_x = centres(x)
    y, _ = klein_sample_batch(pre, B, seed=seed, step=step,
                              chain_offset=chain_offset, centers=cs_x)
    cs_y = centres(y)
    log_q_y_x = klein_log_density(y, dataclasses.replace(pre, cs=cs_x))
    log_q_x_y = klein_log_density(x, dataclasses.replace(pre, cs=cs_y))

    def log_pi(z):
        resid = (z @ pre.U.T - pre.cs) * r_diag
        return -0.5 * (resid * resid).sum(dim=-1) / pre.sigma ** 2

    log_ratio = log_pi(y) + log_q_x_y - log_pi(x) - log_q_y_x
    u = _accept_uniform(seed, B, chain_offset, step, log_ratio.dtype,
                        pre.device)
    accept = torch.log(u) < log_ratio
    return ChainState(coeffs=torch.where(accept[:, None], y, x),
                      log_w=state.log_w,
                      accepted=state.accepted + accept.to(torch.int32),
                      steps=step)


def _eager_run(state, step_fn, n_samples, thin, burn_in):
    for _ in range(burn_in):
        state = step_fn(state)
    coeffs, log_ws = [], []
    for _ in range(n_samples):
        for _ in range(thin):
            state = step_fn(state)
        coeffs.append(state.coeffs)
        log_ws.append(state.log_w)
    return torch.stack(coeffs, dim=1), torch.stack(log_ws, dim=1), state


def _eager_sweep(seed, step, chains, x, e, G, sigma, window):
    n = x.shape[1]
    g_diag = torch.diagonal(G)
    sigmas = sigma * torch.sqrt(1.0 / g_diag)
    u = philox_uniform(seed, chains, step, torch.arange(n), TAG_GIBBS).to(
        x.dtype)
    for i in range(n):
        mu = x[:, i] - e[:, i] / g_diag[i]
        z = sample_dgauss_inverse_cdf(u[i], mu, sigmas[i], window)
        e += (z - x[:, i])[:, None] * G[:, i][None, :]
        x[:, i] = z


def _eager_gibbs_chain(seed, lattice, target, sigma, n_sweeps, x0=None,
                       window=64):
    B = lattice.basis
    G, t = B.T @ B, torch.as_tensor(target).to(B.dtype)
    Bt = t @ B
    if x0 is None:
        x0 = lattice.nearest_plane(t)
    x0 = torch.as_tensor(x0).to(G.dtype)
    single = x0.ndim == 1
    x = x0.reshape(-1, lattice.n).clone()
    e = x @ G - Bt
    chains = chain_ids(x.shape[0], 0)
    sig = torch.as_tensor(sigma, dtype=G.dtype)
    trace = []
    for s in range(n_sweeps):
        _eager_sweep(seed, s + 1, chains, x, e, G, sig, window)
        trace.append(x[0].clone() if single else x.clone())
    return torch.stack(trace), (x[0] if single else x)


def _eager_annealed(seed, lattice, target, sigma0, n_sweeps, n_chains,
                    alpha=0.9, window=64):
    B = lattice.basis
    G, t = B.T @ B, torch.as_tensor(target).to(B.dtype)
    Bt = t @ B
    T, C, n = t.shape[0], n_chains, lattice.n
    dt = G.dtype
    x_babai = lattice.nearest_plane(t).to(dt)
    chains = chain_ids(T * C, 0)
    u = philox_uniform(seed, chains, 0, torch.arange(n), TAG_GIBBS).T.to(dt)
    pert = torch.floor(3.0 * u) - 1.0
    pert.view(T, C, n)[:, 0] = 0.0
    x = (x_babai[:, None, :] + pert.view(T, C, n)).reshape(T * C, n)
    Bt_c = Bt.repeat_interleave(C, dim=0)
    e = x @ G - Bt_c

    def dist2(x, e):
        return (x * (e - Bt_c)).sum(dim=1)

    best_x, best_d = x.clone(), dist2(x, e)
    for s in range(n_sweeps):
        sig = torch.tensor(sigma0 * alpha ** s, dtype=dt)
        _eager_sweep(seed, s + 1, chains, x, e, G, sig, window)
        d = dist2(x, e)
        better = d < best_d
        best_x[better] = x[better]
        best_d = torch.where(better, d, best_d)
    i = best_d.view(T, C).argmin(dim=1)
    bx = best_x.view(T, C, n)[torch.arange(T), i]
    point = bx @ lattice.basis.T
    return point, bx, ((point - t) ** 2).sum(dim=1)


def _eager_mhk(seed, lat, targets, sigma, n_steps, window):
    pre0 = klein_precompute(lat, sigma, window=window)
    dt = pre0.U.dtype
    t = targets.to(dt)
    cs_t = (t @ lat.Q.to(dt)) / torch.diagonal(lat.R).to(dt)
    pre_t = dataclasses.replace(pre0, cs=cs_t)
    T = t.shape[0]

    def d2(x):
        return ((x @ lat.basis.T.to(dt) - t) ** 2).sum(dim=1)

    x = lat.nearest_plane(t).to(dt)
    lw = klein_log_weight(x, pre_t)
    best_x, best_d = x.clone(), d2(x)
    for s in range(1, n_steps + 1):
        y, lw_y = klein_sample_batch(pre0, T, seed=seed, step=s,
                                     centers=cs_t)
        u = _accept_uniform(seed, T, 0, s, dt, t.device)
        take = torch.log(u) < lw_y - lw
        x = torch.where(take[:, None], y, x)
        lw = torch.where(take, lw_y, lw)
        d = d2(x)
        better = d < best_d
        best_x = torch.where(better[:, None], x, best_x)
        best_d = torch.where(better, d, best_d)
    return best_x, best_d


def _triangular(n, seed=3):
    rng = np.random.default_rng(seed)
    basis = np.triu(rng.uniform(-1, 1, (n, n)), 1) + np.diag(
        rng.uniform(1, 2, n))
    return lattice_from_basis(basis, device="cpu"), rng


# ---------------------------------------------------------------------------
# Philox at a device step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1,
                                  2 ** 32 + 3, 2 ** 40 + 9])
@pytest.mark.parametrize("tag", [TAG_ROW, TAG_ACCEPT, TAG_GIBBS])
def test_tensor_step_philox_equals_the_int_step(step, tag):
    chains = chain_ids(37, 5)
    rows = torch.arange(11)
    want = philox_words(2 ** 33 + 17, chains, step, rows, tag)
    for counter in (torch.tensor([step]), torch.tensor(step)):
        got = philox_words(2 ** 33 + 17, chains, counter, rows, tag)
        _equal(got, want)
        _equal([philox_uniform(9, chains, counter, rows, tag)],
               [philox_uniform(9, chains, step, rows, tag)])


# ---------------------------------------------------------------------------
# The refactored chains against the eager code, bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_imhk_chains_equal_the_eager_code(route):
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    pre = klein_precompute(lat, HARD_SIGMA)
    got = imhk_chains(pre, 4, 20, thin=2, burn_in=3, seed=5, chain_offset=7)
    state = imhk_init(pre, 4, seed=5, chain_offset=7)
    want = _eager_run(state, lambda st: _eager_imhk_step(st, pre, 5, 7),
                      20, 2, 3)
    _equal(got[:2], want[:2])
    _equal([got[2].coeffs, got[2].log_w, got[2].accepted],
           [want[2].coeffs, want[2].log_w, want[2].accepted])
    assert got[2].steps == want[2].steps == 43
    # one chain, the facade `imhk_chain`, on a 12-dimensional basis
    lat, _ = _triangular(12)
    pre = klein_precompute(lat, 1.0)
    c, lw, st = imhk_chain(pre, 9, seed=2, chain_offset=3)
    want = _eager_run(imhk_init(pre, 1, seed=2, chain_offset=3),
                      lambda s: _eager_imhk_step(s, pre, 2, 3), 9, 1, 0)
    _equal([c, lw, st.accepted], [want[0][0], want[1][0], want[2].accepted])


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_smk_chains_equal_the_eager_code(route):
    lat, _ = _triangular(12)
    pre = klein_precompute(lat, 1.0)
    pre_h = dataclasses.replace(pre, sigmas=pre.sigmas * 0.5)
    coeffs, state = smk_chains(pre_h, lat.Q, lat.R, 5, 6, thin=2, burn_in=2,
                               seed=4, chain_offset=1)
    want = _eager_run(imhk_init(pre_h, 5, seed=4, chain_offset=1),
                      lambda s: _eager_smk_step(s, pre_h, lat.Q, lat.R, 4, 1),
                      6, 2, 2)
    _equal([coeffs, state.coeffs, state.log_w, state.accepted],
           [want[0], want[2].coeffs, want[2].log_w, want[2].accepted])
    assert state.steps == want[2].steps == 14
    assert 0 < int(state.accepted.sum()) < 5 * 14


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_gibbs_chain_equals_the_eager_code(route):
    lat, rng = _triangular(12)
    t = torch.from_numpy(rng.normal(scale=2.0, size=12))
    got = gibbs_chain(3, lat, t, 0.8, 7, x0=torch.zeros(6, 12))
    want = _eager_gibbs_chain(3, lat, t, 0.8, 7, x0=torch.zeros(6, 12))
    _equal(got, want)
    # one chain from the Babai point
    _equal(gibbs_chain(3, lat, t, 0.8, 5), _eager_gibbs_chain(3, lat, t,
                                                               0.8, 5))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_annealed_gibbs_decode_equals_the_eager_code(route):
    lat, rng = _triangular(12)
    t = torch.from_numpy(rng.normal(scale=2.0, size=(5, 12)))
    for sweeps in (9, 0):
        _equal(annealed_gibbs_decode(9, lat, t, 1.3, n_sweeps=sweeps,
                                     n_chains=6),
               _eager_annealed(9, lat, t, 1.3, sweeps, 6))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_mhk_decode_batch_equals_the_eager_code(route):
    lat, rng = _triangular(12)
    t = torch.from_numpy(rng.normal(scale=2.0, size=(5, 12)))
    _equal(tdec._mhk_decode_batch(4, lat, t, 0.9, n_steps=11, window=32),
           _eager_mhk(4, lat, t, 0.9, 11, 32))


def test_step_graph_takes_only_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.StepGraph(lambda step, x: (x,), (torch.zeros(2),))
    steps = graphs.stepper(lambda step, x: (x + step,), (torch.zeros(2),), 4)
    assert isinstance(steps, graphs.EagerSteps)
    steps.replay(3)
    assert steps.state[0].tolist() == [5 + 6 + 7] * 2
    with pytest.raises(ValueError, match="shapes and types"):
        StaticBufferSteps(lambda step, x: (x.float(),),
                          (torch.zeros(2, dtype=torch.float64),)).replay()


# ---------------------------------------------------------------------------
# Against the JAX package's chains.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_imhk_chains_law_and_acceptance_match_the_jax_packages(route):
    """2D hard regime: the pooled kept states of both packages' chains
    meet the reference's TVD gate to the enumerated target, and both
    acceptances the enumerated stationary 0.9904."""
    C, T, thin, burn = 8192, 4, 2, 12
    target = enumerate_target(BASIS_2D, HARD_SIGMA, np.zeros(2), radius=15)
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    coeffs, _, state = imhk_chains(klein_precompute(lat, HARD_SIGMA), C, T,
                                   thin=thin, burn_in=burn, seed=11)
    jpre = j_pre(j_lfb(BASIS_2D, dtype=jnp.float64), HARD_SIGMA)
    jc, _, js = j_imhk(jax.random.key(11), jpre, n_chains=C, n_samples=T,
                       thin=thin, burn_in=burn)
    steps = burn + T * thin
    for X, acc in ((coeffs.numpy(), float(state.accepted.sum())),
                   (np.asarray(jc), float(np.asarray(js.accepted).sum()))):
        assert tvd_dicts(empirical_dist(X.reshape(-1, 2)), target) < TVD_GATE
        assert abs(acc / (C * steps) - HARD_ACCEPTANCE) < ACCEPTANCE_TOL
    assert state.steps == steps and int(np.asarray(js.steps)[0]) == steps


def test_smk_chains_law_matches_the_jax_packages():
    """2D hard regime, proposal width sigma (`tests/test_torch_smk.py`'s
    law test): both packages' SMK chains meet the TVD gate, and their
    acceptances agree within 4 binomial standard errors of their
    difference."""
    C, T, thin, burn = 8192, 2, 2, 6
    target = enumerate_target(BASIS_2D, HARD_SIGMA, np.zeros(2), radius=15)
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    pre = klein_precompute(lat, HARD_SIGMA)
    coeffs, state = smk_chains(pre, lat.Q, lat.R, C, T, thin=thin,
                               burn_in=burn, seed=6)
    jlat = j_lfb(BASIS_2D, dtype=jnp.float64)
    jp = j_pre(jlat, HARD_SIGMA)
    jc, js = jax.vmap(lambda k: j_smk(k, jp, jlat.Q, jlat.R, T, thin, burn))(
        jax.random.split(jax.random.key(6), C))
    steps = C * (burn + T * thin)
    rates = []
    for X, acc in ((coeffs.numpy(), float(state.accepted.sum())),
                   (np.asarray(jc), float(np.asarray(js.accepted).sum()))):
        assert tvd_dicts(empirical_dist(X.reshape(-1, 2)), target) < TVD_GATE
        rates.append(acc / steps)
    se = np.sqrt(sum(r * (1 - r) / steps for r in rates))
    assert 0.05 < rates[0] < 0.95
    assert abs(rates[0] - rates[1]) < 4 * se


def test_gibbs_chain_law_matches_the_jax_packages():
    """Fixed-temperature Gibbs on [[1, .5], [0, 1]] at sigma 1.2: the
    port's 20,000 chains after 30 sweeps (`tests/test_torch_unified.py`'s
    law test) and the JAX package's one chain of 30,000 sweeps (its test,
    burn-in 1,000) both follow the enumerated law."""
    target = enumerate_target(BASIS_2D, 1.2, np.zeros(2), radius=15)
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    _, x = gibbs_chain(5, lat, torch.zeros(2), 1.2, 30,
                       x0=torch.zeros(20_000, 2))
    assert tvd_dicts(empirical_dist(x.numpy()), target) < TVD_GATE
    trace, _ = j_gibbs(jax.random.key(5), j_lfb(BASIS_2D, dtype=jnp.float64),
                       jnp.zeros(2), 1.2, n_sweeps=30_000)
    emp = empirical_dist(np.asarray(trace)[1000:])
    assert tvd_dicts(emp, target) < GIBBS_JAX_TVD_GATE


def test_annealed_gibbs_decodes_as_the_jax_package_does():
    """The JAX package's planted-CVP test instance: both decoders return
    x* exactly, within the noise's distance."""
    rng = np.random.default_rng(0)
    B = rng.integers(-4, 5, size=(6, 6)).astype(np.float64)
    while abs(np.linalg.det(B)) < 1:
        B = rng.integers(-4, 5, size=(6, 6)).astype(np.float64)
    x_star = rng.integers(-3, 4, size=6).astype(np.float64)
    noise = rng.normal(scale=0.05, size=6)
    t = B @ x_star + noise
    _, jx, _ = j_anneal(jax.random.key(0), j_lfb(B, dtype=jnp.float64),
                        jnp.asarray(t), sigma0=2.0, n_sweeps=40, n_chains=32)
    _, x, d2 = annealed_gibbs_decode(0, lattice_from_basis(B, device="cpu"),
                                     torch.from_numpy(t), 2.0, n_sweeps=40,
                                     n_chains=32)
    np.testing.assert_array_equal(x.numpy(), x_star)
    np.testing.assert_array_equal(np.asarray(jx), x_star)
    assert float(d2) <= np.sum(noise ** 2) + 1e-9


def test_mhk_decode_matches_the_jax_packages():
    """The decoding driver's channel lattice at n = 16 (same numpy seed in
    both packages): at noise 0.05 both MHK decoders recover every x*; at
    0.45 neither is farther than Babai on any target."""
    n, count = 16, 24
    lat = tdec._channel_lattice(np.random.default_rng(42), n, device="cpu")
    jlat = jdec._channel_lattice(np.random.default_rng(42), n, jnp.float64)
    rng = np.random.default_rng(1)
    basis = lat.basis.numpy()
    min_gs = float(lat.gs_norms.min())
    sigma = 0.35 * min_gs
    for rho in (0.05, 0.45):
        xs = rng.integers(-2, 3, size=(count, n)).astype(np.float64)
        t = xs @ basis.T + rng.normal(scale=rho * min_gs, size=(count, n))
        x, d = tdec._mhk_decode_batch(7, lat, torch.from_numpy(t), sigma,
                                      n_steps=32, window=tdec.MHK_WINDOW)
        jx, jd = jdec._mhk_decode_batch(jax.random.key(7), jlat,
                                        jnp.asarray(t), sigma, 32,
                                        tdec.MHK_WINDOW)
        xb = lat.nearest_plane(torch.from_numpy(t))
        db = ((xb @ lat.basis.T - torch.from_numpy(t)) ** 2).sum(dim=1)
        assert bool((d <= db + 1e-9).all())
        assert bool((np.asarray(jd) <= db.numpy() + 1e-9).all())
        if rho == 0.05:
            np.testing.assert_array_equal(x.numpy(), xs)
            np.testing.assert_array_equal(np.asarray(jx), xs)


# ---------------------------------------------------------------------------
# Hazard C15.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,raises", [(128, False), (256, False),
                                      (1024, True)])
def test_c15_predicate_on_debug_sigmas_basis(n, raises):
    """`tools/debug_sigma.py`'s random unit-triangular basis at its sigma
    2 eta: the predicted |y| passes 256 from n = 128 on (the WIDE
    instantiations) and 2^24 at n = 1024, where the wrappers raise."""
    rng = np.random.default_rng(0)
    B = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
    np.fill_diagonal(B, 1.0)
    lat = lattice_from_basis(B, device="cpu")
    pre = klein_precompute(lat, 2.0 * float(smoothing_parameter(lat)))
    ops = klein_cuda.kernel_operands(pre)
    assert klein_cuda.wide_y(ops)
    assert (klein_cuda.predicted_y(ops) >= klein_cuda.WIDE_Y) == raises
    if raises:
        with pytest.raises(ValueError, match=r"klein_draw: .*2\^24.*C15"):
            klein_cuda.check_reach(ops, "klein_draw")
    else:
        klein_cuda.check_reach(ops, "klein_draw")


def test_c15_prediction_follows_an_in_place_change():
    """On [[1, 3e7], [0, 1]] at sigma 1 the prediction is ~2.1e8; a
    coupling cut in place to 1e3 brings it back within reach, and a
    non-finite prediction raises too."""
    lat = lattice_from_basis(np.array([[1.0, 3e7], [0.0, 1.0]]),
                             device="cpu")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 1.0))
    assert klein_cuda.predicted_y(ops) > 2e8
    with pytest.raises(ValueError, match="C15"):
        klein_cuda.check_reach(ops, "imhk_fused")
    ops.U[0, 1] = 1e3
    assert 256 < klein_cuda.predicted_y(ops) < klein_cuda.WIDE_Y
    klein_cuda.check_reach(ops, "imhk_fused")
    ops.cs[0] = float("nan")
    with pytest.raises(ValueError, match="C15"):
        klein_cuda.check_reach(ops, "imhk_fused")
