"""The port's unified sampler facade and Gibbs decoding: dispatch and its
errors as in `tests/unit/test_unified.py`, annealed Gibbs never worse than
Babai (chain 0 sits at the Babai point), the Gibbs chain's law in 2D, and
the entry points' refusal to run without a card unless asked."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch import samplers
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    UnifiedLatticeSampler,
    annealed_gibbs_decode,
    gibbs_chain,
    identity_lattice,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_identity_dispatch():
    lat = identity_lattice(8, device=CPU)
    s = UnifiedLatticeSampler(lat, sigma=3.0, device=CPU)
    assert s.algorithm == "direct"
    pts = s.sample(1, 2000)
    assert pts.shape == (2000, 8)
    assert abs(float(pts.std()) - 3.0) < 0.1


def test_generic_dispatch_and_exact():
    lat = lattice_from_basis(np.array([[2.0, 1.0], [0.0, 3.0]]), device=CPU)
    s = UnifiedLatticeSampler(lat, sigma=5.0, device=CPU)
    assert s.algorithm == "klein"
    assert isinstance(s._impl, samplers.KleinSampler)
    assert s.sample(1, 500).shape == (500, 2)
    se = UnifiedLatticeSampler(lat, sigma=5.0, exact=True, device=CPU)
    assert se.algorithm == "imhk"
    assert se.sample(1, 100).shape == (100, 2)
    sm = UnifiedLatticeSampler(lat, sigma=5.0, algorithm="smk",
                               proposal_sigma=3.0, device=CPU)
    assert sm.algorithm == "smk"
    assert sm.sample(2, 50, burn_in=5).shape == (50, 2)
    assert 0.0 < sm._impl.acceptance_rate <= 1.0


def test_peikert_dispatch_and_errors():
    rng = np.random.default_rng(3)
    B0 = np.triu(rng.uniform(-0.5, 0.5, (8, 8))) + np.eye(8)
    lat = lattice_from_basis(B0, device=CPU)
    s1 = float(np.linalg.norm(B0, 2))
    s = UnifiedLatticeSampler(lat, sigma=4.0 * s1, algorithm="peikert",
                              device=CPU)
    assert s.algorithm == "peikert"
    assert s.sample(1, 512).shape == (512, 8)
    with pytest.raises(ValueError):
        UnifiedLatticeSampler(lat, sigma=0.1, algorithm="peikert",
                              device=CPU)
    with pytest.raises(ValueError, match="unknown algorithm"):
        UnifiedLatticeSampler(lat, sigma=3.0, algorithm="nope", device=CPU)
    with pytest.raises(ValueError, match="only on Z"):
        UnifiedLatticeSampler(lat, sigma=3.0, algorithm="direct", device=CPU)


def test_default_sigma_and_short_vector():
    lat = lattice_from_basis(np.array([[3.0, 1.0], [1.0, 3.0]]), device=CPU)
    s = UnifiedLatticeSampler(lat, device=CPU)
    # 1.5 x the smoothing-parameter bound
    assert s.sigma == pytest.approx(
        1.5 * float(samplers.unified.smoothing_parameter(lat)))
    s = UnifiedLatticeSampler(lat, sigma=4.0, device=CPU)
    v = s.short_vector(5, 2000).numpy()
    assert 0 < np.linalg.norm(v) < 8.0


def test_decode_babai_and_stochastic():
    rng = np.random.default_rng(42)
    B = rng.integers(-4, 5, size=(4, 4)).astype(np.float64)
    while abs(np.linalg.det(B)) < 1:
        B = rng.integers(-4, 5, size=(4, 4)).astype(np.float64)
    lat = lattice_from_basis(B, device=CPU)
    s = UnifiedLatticeSampler(lat, sigma=2.0, device=CPU)
    x_star = rng.integers(-2, 3, size=4).astype(np.float64)
    t = torch.from_numpy(B @ x_star + rng.normal(scale=0.05, size=4))
    _, coeffs = s.decode(3, t, stochastic=True, n_sweeps=30, n_chains=16)
    np.testing.assert_array_equal(coeffs.numpy(), x_star)
    pt2, coeffs2 = s.decode(3, t, stochastic=False)
    assert pt2.shape == (4,)
    np.testing.assert_array_equal(coeffs2.numpy(), lat.nearest_plane(t))


def test_annealed_gibbs_never_worse_than_babai():
    """Noisy targets where Babai often misses: per target the decoder's
    distance is at most Babai's, and with no sweeps it returns the Babai
    point (chain 0 starts there unperturbed)."""
    rng = np.random.default_rng(7)
    n, T = 8, 32
    basis = np.eye(n) + np.triu(rng.uniform(-0.9, 0.9, (n, n)), 1)
    lat = lattice_from_basis(basis, device=CPU)
    xs = rng.integers(-2, 3, (T, n)).astype(np.float64)
    t = torch.from_numpy(xs @ basis.T + rng.normal(scale=0.45, size=(T, n)))
    xb = lat.nearest_plane(t)
    db = ((xb @ lat.basis.T - t) ** 2).sum(dim=1)
    pts, X, d2 = annealed_gibbs_decode(11, lat, t, sigma0=0.7, n_sweeps=20,
                                       n_chains=8)
    assert pts.shape == (T, n) and X.shape == (T, n) and d2.shape == (T,)
    assert bool((d2 <= db + 1e-9).all())
    assert bool((d2 < db - 1e-9).any())       # it does improve somewhere
    torch.testing.assert_close(pts, X @ lat.basis.T)
    _, X0, d0 = annealed_gibbs_decode(11, lat, t, sigma0=0.7, n_sweeps=0,
                                      n_chains=8)
    np.testing.assert_array_equal(X0.numpy(), xb.numpy())
    torch.testing.assert_close(d0, db)
    # one target at a time gives the batch's answer for that target
    p1, x1, _ = annealed_gibbs_decode(11, lat, t[0], sigma0=0.7,
                                      n_sweeps=20, n_chains=8)
    assert x1.shape == (n,) and p1.shape == (n,)
    np.testing.assert_array_equal(x1.numpy(), X[0].numpy())


def test_gibbs_chain_2d_law():
    """A fixed-temperature Gibbs chain per start on [[1, .5], [0, 1]]:
    after 30 sweeps 20,000 chains are at pi(x) ~ exp(-||Bx - t||^2 /
    (2 sigma^2)); TVD to the enumerated law < 0.02."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device=CPU)
    t = np.array([0.3, -0.2])
    sigma, C = 1.2, 20_000
    trace, x = gibbs_chain(5, lat, torch.from_numpy(t), sigma, 30,
                           x0=torch.zeros(C, 2))
    assert trace.shape == (30, C, 2) and torch.equal(trace[-1], x)
    r = np.arange(-8, 9)
    grid = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    d = grid @ basis.T - t
    p = np.exp(-0.5 * (d ** 2).sum(1) / sigma ** 2)
    p /= p.sum()
    X = x.numpy().astype(np.int64)
    emp = np.bincount((X[:, 0] + 8) * 17 + X[:, 1] + 8,
                      minlength=17 * 17) / C
    assert 0.5 * np.abs(emp - p).sum() < 0.02
    # one chain from the Babai point
    tr1, x1 = gibbs_chain(5, lat, torch.from_numpy(t), sigma, 4)
    assert tr1.shape == (4, 2) and x1.shape == (2,)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        identity_lattice(4)
    lat = identity_lattice(4, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnifiedLatticeSampler(lat, sigma=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        samplers.sample_zn(0, 4, 2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        samplers.KleinSampler(lat, 2.0)
