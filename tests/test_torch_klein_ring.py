"""Klein's ring mode (kernel B6) and `KleinSampler` in the port: the plain
version of B6 against `klein_sample_ring_pallas` in interpret mode on the
wrapper's own uniforms, round 0 against B1, and the sampler's law in 2D
against the enumerated target."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as jlat
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    klein_sample_ring_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    KleinSampler,
    klein_precomp_from_numpy,
)

N, B, ROUNDS = 136, 256, 3
N_PAD = 256
# lw: a sum of 136 float32 log-normalizers, summed in another order than
# the Pallas kernel's (see tests/test_torch_klein_cuda.py)
LW_ATOL = 1e-4
# chains whose draw differs through a CDF-boundary tie, per round, and each
# such chain first differs by exactly one (tests/test_torch_klein_cuda.py)
MAX_TIE_CHAINS = 0.05
MAX_TVD = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pres():
    rng = np.random.default_rng(136)
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = jlat(basis, dtype=jnp.float64)
    pre = klein_precompute(lat, 1.3, center=rng.normal(scale=10.0, size=N))
    d = {k: np.asarray(getattr(pre, k))
         for k in ("basis", "U", "cs", "sigmas", "sigma")}
    d.update(window=pre.window, clamped=pre.clamped)
    return pre, klein_precomp_from_numpy(d, device="cpu")


def test_b6_plain_matches_pallas_ring(pres):
    pre, pre_t = pres
    key = jax.random.key(8)
    with pltpu.force_tpu_interpret_mode():
        Xp, lwp = klein_sample_ring_pallas(key, pre, B, n_rounds=ROUNDS,
                                           host_rng=True, tile=128)
    _, k_unif = jax.random.split(key)
    unif = np.array(jax.random.uniform(k_unif, (ROUNDS * N_PAD, B),
                                        dtype=jnp.float32))
    ops = klein_cuda.kernel_operands(pre_t)
    ring, lw = klein_cuda.klein_ring(ops, B, ROUNDS,
                                     uniforms=torch.from_numpy(unif))
    assert ring.shape == (ROUNDS * N_PAD, B) and lw.shape == (ROUNDS, B)
    X = klein_cuda.ring_coeffs(ops, ring).numpy()
    Xp, lwp = np.asarray(Xp), np.asarray(lwp)
    assert X.shape == Xp.shape == (ROUNDS, B, N)
    for r in range(ROUNDS):
        diff = X[r] != Xp[r]
        ties = diff.any(axis=1)
        assert ties.mean() <= MAX_TIE_CHAINS, (r, ties.sum())
        for b in np.flatnonzero(ties):
            first = np.flatnonzero(diff[b]).max()
            assert abs(X[r, b, first] - Xp[r, b, first]) == 1
        np.testing.assert_allclose(lw[r].numpy()[~ties], lwp[r][~ties],
                                   atol=LW_ATOL)
    assert not np.array_equal(X[0], X[1])


def test_b6_round0_is_b1_bit_for_bit(pres):
    _, pre_t = pres
    ops = klein_cuda.kernel_operands(pre_t)
    g = torch.Generator().manual_seed(1)
    u = torch.rand(ROUNDS * N_PAD, 64, generator=g)
    ring, lw = klein_cuda.klein_ring(ops, 64, ROUNDS, uniforms=u)
    y, lw1 = klein_cuda.klein_draw(ops, 64, uniforms=u[:N_PAD])
    assert torch.equal(ring[:N_PAD], y) and torch.equal(lw[0], lw1)
    # on Philox: round r is B1's draw at step `step + r`
    ring, lw = klein_cuda.klein_ring(ops, 64, ROUNDS, seed=4, step=2)
    for r in range(ROUNDS):
        y, lw1 = klein_cuda.klein_draw(ops, 64, seed=4, step=2 + r)
        assert torch.equal(ring[r * N_PAD:(r + 1) * N_PAD], y)
        assert torch.equal(lw[r], lw1)


def _enumerated(basis, sigma, radius=8):
    r = np.arange(-radius, radius + 1)
    grid = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    pts = grid @ basis.T
    logp = -0.5 * (pts ** 2).sum(1) / sigma ** 2
    p = np.exp(logp - logp.max())
    return grid, p / p.sum()


def _tvd(X, basis, sigma):
    grid, p = _enumerated(basis, sigma)
    X = X.astype(np.int64)
    inside = (np.abs(X) <= 8).all(axis=1)
    idx = (X[inside, 0] + 8) * 17 + (X[inside, 1] + 8)
    emp = np.bincount(idx, minlength=17 * 17) / X.shape[0]
    return 0.5 * (np.abs(emp - p).sum() + (1.0 - inside.mean()))


def test_klein_sampler_2d_law():
    """sigma = 2 on [[1, .5], [0, 1]], where Klein's law is close to
    D_{L,sigma}: TVD to the enumerated target < 0.02."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device="cpu")
    s = KleinSampler(lat, 2.0, device="cpu")
    X = s.sample(3, 100_000, return_coeffs=True)
    assert X.shape == (100_000, 2)
    assert _tvd(X.numpy(), basis, 2.0) < MAX_TVD
    pts = s.sample(3, 10)
    np.testing.assert_allclose(pts.numpy(), X[:10].numpy() @ basis.T)
    Xw, lw = s.sample_with_weights(3, 10)
    assert torch.equal(Xw, X[:10]) and lw.shape == (10,)
    assert torch.isfinite(s.log_density(X[:10])).all()
    info = s.diagnostic_info()
    assert info["window"] == s.pre.window and info["sigma"] == 2.0
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        s.sample(3, 10, backend="cuda")


def test_klein_sampler_warns_below_klein_bound():
    lat = lattice_from_basis(np.diag([1.0, 40.0]), device="cpu")
    with pytest.warns(UserWarning, match="below Klein requirement"):
        KleinSampler(lat, 1.0, device="cpu")
