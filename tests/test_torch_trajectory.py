"""The IMHK trajectory (kernel B3's plain version, `imhk_chains` and
`IMHKSampler.sample`) on the CPU: B3 against B2 on the same stream, B3
against the Pallas fused step driven one step at a time on the same host
uniforms, the trajectory's law in the 2D hard regime, and the sampler's
automatic burn-in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    imhk_step_pallas_fused,
    klein_sample_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    estimate_burn_in,
    imhk_chains,
    klein_precomp_from_numpy,
    klein_sample_batch,
    spectral_gap_mc,
)
from tests.unit.test_klein import empirical_dist, enumerate_target, tvd_dicts

N, B = 136, 256
N_PAD = 256
# lw is a sum of 136 float32 log-normalizers, summed in float64 by the port
# and Kahan-summed in float32 by Pallas: 1e-4 absolute is rounding margin
LW_ATOL = 1e-4
# share of (step, chain) states that a float32 CDF-boundary tie (Pallas sums
# the coupling in bf16 pieces, the port in FP32) may leave different
MAX_TIE_SHARE = 0.05
TVD_GATE = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pres():
    rng = np.random.default_rng(136)
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    center = rng.normal(scale=10.0, size=N)
    # conditional widths 0.3-0.6: the hard regime, where MH rejects
    pre = j_pre(j_lfb(basis, dtype=jnp.float64), 0.6, center=center)
    d = {k: np.asarray(getattr(pre, k))
         for k in ("basis", "U", "cs", "sigmas", "sigma")}
    d.update(window=pre.window, clamped=pre.clamped)
    return pre, klein_precomp_from_numpy(d, device="cpu")


def test_b3_plain_is_b2_plain_with_a_ring(pres):
    """B3's ring holds the lw after every thin-th step and its state; its
    final state, lw and counts are B2's, bit for bit, on the same stream."""
    _, pre_t = pres
    ops = klein_cuda.kernel_operands(pre_t)
    y, lw = klein_cuda.klein_draw(ops, B, seed=3, step=0)
    n_keep, thin = 3, 2
    x3, l3, a3 = y.clone(), lw.clone(), torch.zeros(B)
    x3, l3, a3, tx, tlw = klein_cuda.imhk_trajectory(
        ops, x3, l3, a3, n_keep, thin, seed=3, step=1, coeffs=True)
    assert tx.shape == (n_keep * N_PAD, B) and tlw.shape == (n_keep, B)
    x2, l2, a2 = y.clone(), lw.clone(), torch.zeros(B)
    for k in range(n_keep):
        klein_cuda.imhk_fused(ops, x2, l2, a2, thin, seed=3,
                              step=1 + k * thin)
        torch.testing.assert_close(tlw[k], l2, rtol=0, atol=0)
        torch.testing.assert_close(tx[k * N_PAD:(k + 1) * N_PAD], x2,
                                   rtol=0, atol=0)
    for got, want in ((x3, x2), (l3, l2), (a3, a2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 < float(a3.sum()) < n_keep * thin * B


def test_b3_plain_matches_pallas_step_by_step(pres):
    """imhk_trajectory_pallas draws its own bits, so the Pallas side is
    `imhk_step_pallas_fused` called once per step with host uniforms; the
    port's B3 gets the same uniforms, n_pad + 8 rows per step."""
    pre, pre_t = pres
    key = jax.random.key(11)
    T = 3
    with jax.experimental.pallas.tpu.force_tpu_interpret_mode():
        X0, lw0 = klein_sample_batch_pallas(key, pre, B, host_rng=True,
                                            tile=128)
    X, lwj, accj = np.array(X0), lw0, jnp.zeros((B,), jnp.float32)
    states, lws, unifs = [], [], []
    for s in range(T):
        ks = jax.random.fold_in(key, 100 + s)
        Xp, lwj, accj = imhk_step_pallas_fused(
            ks, pre, jnp.asarray(X), lwj, accj, tile=128, n_steps=1,
            interpret=True, host_rng=True)
        # the interpreter returns NaN states for chains that reject (the
        # aliased state buffer is not carried in): they kept their state
        Xp = np.array(Xp)
        lost = np.isnan(Xp).any(axis=1)
        Xp[lost] = X[lost]
        X = Xp
        states.append(X.copy())
        lws.append(np.asarray(lwj))
        _, k_unif = jax.random.split(ks)
        unifs.append(np.array(jax.random.uniform(
            k_unif, (N_PAD + 8, B), dtype=jnp.float32)))
    ops = klein_cuda.kernel_operands(pre_t)
    x = klein_cuda.to_kernel_layout(ops, torch.tensor(np.asarray(X0)))
    lw = torch.tensor(np.asarray(lw0, dtype=np.float32))
    acc = torch.zeros(B)
    x, lw, acc, tx, tlw = klein_cuda.imhk_trajectory(
        ops, x, lw, acc, T, 1, coeffs=True,
        uniforms=torch.from_numpy(np.concatenate(unifs)))
    traj = klein_cuda.trajectory_coeffs(ops, tx).reshape(B, T, N).numpy()
    differing = 0
    for k in range(T):
        same = (traj[:, k] == states[k]).all(axis=1)
        differing += int((~same).sum())
        np.testing.assert_allclose(tlw[k].numpy()[same], lws[k][same],
                                   atol=LW_ATOL)
    assert differing <= MAX_TIE_SHARE * T * B, differing
    np.testing.assert_array_equal(acc.numpy()[same], np.asarray(accj)[same])
    assert 0 < float(acc.sum()) < T * B      # both outcomes occur


def test_sample_is_the_plain_chains_stream():
    """IMHKSampler.sample on the CPU (B1, B2, B3 plain, float32) and
    `imhk_chains` (per-row, float64) read the same Philox counters: the
    same trajectories up to a rare float32 tie."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device="cpu")
    s = IMHKSampler(lat, 0.35, device="cpu", burn_in=3)
    C, T, thin = 512, 4, 2
    X = s.sample(17, T, thin=thin, n_chains=C, return_coeffs=True)
    assert X.shape == (C * T, 2)
    want, lws, state = imhk_chains(s.pre, C, T, thin=thin, burn_in=3,
                                   seed=17)
    same = (X.reshape(C, T, 2) == want.float()).all(dim=2)
    assert float(same.float().mean()) >= 0.99
    last = s._last_state
    assert last.steps == state.steps == 3 + T * thin
    torch.testing.assert_close(last.coeffs, X.reshape(C, T, 2)[:, -1])
    # points are the basis times the coefficients, chain-major
    pts = s.sample(17, T, thin=thin, n_chains=C)
    torch.testing.assert_close(pts, X.double() @ lat.basis.T)


def test_sample_law_2d_hard_regime():
    """Every kept state after the burn-in is a draw of the target: the
    pooled trajectory meets the reference's TVD gate, and the acceptance is
    the enumerated stationary 0.9904."""
    basis = np.array([[1.0, 0.5], [0.0, 1.0]])
    lat = lattice_from_basis(basis, device="cpu")
    s = IMHKSampler(lat, 0.35, device="cpu", burn_in=12)
    X = s.sample(5, 4, thin=2, n_chains=32_768, return_coeffs=True)
    target = enumerate_target(basis, 0.35, np.zeros(2), radius=15)
    assert tvd_dicts(empirical_dist(X.numpy()), target) < TVD_GATE
    # binomial noise over 2.6e5 decisions is ~2e-4
    assert abs(s.acceptance_rate - 0.9904) < 0.005


def test_sample_backend_routing():
    lat = lattice_from_basis(np.eye(2), device="cpu")
    s = IMHKSampler(lat, 2.0, device="cpu", burn_in=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        s.sample(0, 4, n_chains=8, backend="cuda")
    with pytest.raises(ValueError):
        s.sample(0, 4, n_chains=8, backend="pallas")


@pytest.mark.parametrize("sigma,burn_in", [(0.7, 25), (0.9, 29)])
def test_auto_burn_in_on_cpu_is_unchanged(sigma, burn_in):
    """On the CPU the automatic burn-in still comes from the plain per-row
    Klein draw of 256 chains at seed 0 (the card uses kernel B1)."""
    rng = np.random.default_rng(7)
    n = 24
    basis = np.triu(rng.uniform(-1, 1, (n, n)), 1) + np.diag(
        rng.uniform(1, 3, n))
    lat = lattice_from_basis(basis, device="cpu")
    s = IMHKSampler(lat, sigma, device="cpu")
    _, lw = klein_sample_batch(s.pre, 256, seed=0)
    assert s.burn_in == estimate_burn_in(float(spectral_gap_mc(lw)))
    assert s.burn_in == burn_in
