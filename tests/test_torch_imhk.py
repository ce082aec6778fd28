"""The port's IMHK slice end to end on the CPU: the law of
`IMHKSampler.sample_iid` (plain versions of the kernels) against enumerated
targets, the float64 blocked oracle against the per-row plain draw, the
theory helpers against the JAX package, and the port's isolation from JAX.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu.samplers.imhk import (
    estimate_burn_in as j_burn,
    spectral_gap_mc as j_gap,
)
from lattice_gaussian_mcmc_tpu.samplers.klein import (
    klein_log_weight as j_logw,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    estimate_burn_in,
    imhk_init,
    imhk_step,
    imhk_steps_batch_blocked,
    klein_log_weight,
    klein_precompute,
    klein_sample_batch,
    klein_sample_batch_blocked,
    spectral_gap_mc,
)
from tests.unit.test_klein import empirical_dist, enumerate_target, tvd_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TVD_GATE = 0.02   # the reference's quality gate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("basis,sigma,chains,steps", [
    ([[1.0, 0.5], [0.0, 1.0]], 2.0, 200_000, 3),
    # hard regime: half-integer conditional centres, sigma < 0.5
    ([[1.0, 0.5], [0.0, 1.0]], 0.35, 65_536, 12),
    ([[2.0, 1.0], [0.0, 3.0]], 4.0, 200_000, 3),
])
def test_sample_iid_law_2d(basis, sigma, chains, steps):
    basis = np.array(basis)
    lat = lattice_from_basis(basis, device="cpu")
    s = IMHKSampler(lat, sigma, device="cpu", burn_in=steps)
    X = s.sample_iid(seed=21, num_samples=chains, return_coeffs=True)
    assert X.shape == (chains, 2)
    target = enumerate_target(basis, sigma, np.zeros(2), radius=15)
    assert tvd_dicts(empirical_dist(X.numpy()), target) < TVD_GATE
    assert 0.0 < s.acceptance_rate <= 1.0
    if sigma == 0.35:
        # enumerated stationary acceptance of this regime is 0.9904;
        # binomial noise over 7.9e5 decisions is ~1e-4
        assert abs(s.acceptance_rate - 0.9904) < 0.01


def test_sample_iid_returns_lattice_points():
    basis = np.array([[3.0, 1.0], [1.0, 2.0]])
    lat = lattice_from_basis(basis, device="cpu")
    s = IMHKSampler(lat, 4.0, device="cpu", burn_in=2)
    pts = s.sample_iid(5, 256)
    X = s.sample_iid(5, 256, return_coeffs=True)
    torch.testing.assert_close(pts, X.double() @ lat.basis.T)


def test_blocked_oracle_matches_per_row_draw():
    """The float64 blocked path (the kernel's arithmetic) and the per-row
    plain Klein draw read the same Philox counters, so they draw the same
    integers; their log-weights differ by rounding only."""
    rng = np.random.default_rng(2)
    n = 70
    basis = np.triu(rng.uniform(-0.3, 0.3, (n, n)), 1) + np.diag(
        rng.uniform(1.0, 2.0, n))
    lat = lattice_from_basis(basis, device="cpu")
    pre = klein_precompute(lat, 2.2, center=rng.normal(size=n))
    Xa, lwa = klein_sample_batch(pre, 512, seed=4, step=2)
    Xb, lwb = klein_sample_batch_blocked(pre, 512, seed=4, step=2)
    torch.testing.assert_close(Xb, Xa, rtol=0, atol=0)
    torch.testing.assert_close(lwb, lwa, rtol=0, atol=1e-9)
    torch.testing.assert_close(klein_log_weight(Xa, pre), lwa, rtol=0,
                               atol=1e-9)


def test_blocked_imhk_matches_per_row_steps():
    """imhk_steps_batch_blocked (float64 plain B2) against imhk_step on the
    same counters: same states, log-weights and acceptance counts."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device="cpu")
    pre = klein_precompute(lat, 0.35)
    st = imhk_init(pre, 2048, seed=8)
    X, lw, acc = imhk_steps_batch_blocked(pre, st.coeffs, st.log_w, 5,
                                          seed=8, step=1)
    for _ in range(5):
        st = imhk_step(st, pre, seed=8)
    torch.testing.assert_close(X, st.coeffs, rtol=0, atol=0)
    torch.testing.assert_close(lw, st.log_w, rtol=0, atol=1e-9)
    torch.testing.assert_close(acc, st.accepted, rtol=0, atol=0)
    assert st.steps == 5 and 0 < int(acc.sum()) < 5 * 2048


def test_log_weight_and_theory_helpers_match_jax():
    rng = np.random.default_rng(3)
    basis = np.triu(rng.uniform(-1, 1, (5, 5)), 1) + np.diag(
        [1.5, 2.0, 1.0, 1.2, 2.4])
    jpre = j_pre(j_lfb(basis, dtype=jnp.float64), 1.9)
    pre = klein_precompute(lattice_from_basis(basis, device="cpu"), 1.9)
    X = rng.integers(-4, 5, size=(64, 5)).astype(np.float64)
    np.testing.assert_allclose(
        klein_log_weight(torch.from_numpy(X), pre).numpy(),
        np.asarray(j_logw(jnp.asarray(X), jpre)), atol=1e-12)
    lw = rng.normal(size=300)
    np.testing.assert_allclose(float(spectral_gap_mc(torch.from_numpy(lw))),
                               float(j_gap(jnp.asarray(lw))), rtol=1e-12)
    for d in (0.9, 0.05, 1e-9):
        assert estimate_burn_in(d) == j_burn(d)


def test_backend_cuda_on_cpu_sampler_raises():
    lat = lattice_from_basis(np.eye(2), device="cpu")
    s = IMHKSampler(lat, 2.0, device="cpu", burn_in=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        s.sample_iid(0, 16, backend="cuda")
    with pytest.raises(ValueError):
        s.sample_iid(0, 16, backend="pallas")


def test_no_hidden_cpu_fallback():
    """Without a card, a sampler not told device='cpu' raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lat = lattice_from_basis(np.eye(2), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IMHKSampler(lat, 2.0, burn_in=1).sample_iid(0, 16)


def test_port_imports_no_jax():
    """In a fresh interpreter where importing jax fails, the port imports
    and samples on the CPU, and the JAX package is never loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np
        import lattice_gaussian_mcmc_tpu_torch as lt
        lat = lt.lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                                    device="cpu")
        X = lt.IMHKSampler(lat, 1.0, device="cpu").sample_iid(
            0, 64, n_steps=2, return_coeffs=True)
        assert X.shape == (64, 2)
        bad = [m for m in sys.modules
               if m == "lattice_gaussian_mcmc_tpu"
               or m.startswith("lattice_gaussian_mcmc_tpu.")]
        assert not bad, bad
        print("isolated")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "isolated" in r.stdout
