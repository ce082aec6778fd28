"""Symmetric Metropolis-Klein on the CPU: kernel B4's plain version against
the Pallas SMK kernel (interpret mode, host uniforms, debug outputs) at
n = 136, against the straightforward `smk_step` formulation decision by
decision in the 2D hard regime, and the law of the plain chain and of
`sample_iid` against the enumerated target."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as j_lfb
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    klein_sample_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.ops.kernels.smk_pallas import (
    smk_steps_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute as j_pre
from lattice_gaussian_mcmc_tpu.samplers.klein import (
    klein_log_density as j_log_density,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, smk_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    ChainState,
    MetropolisKleinSampler,
    SMKSampler,
    klein_log_density,
    klein_precomp_from_numpy,
    smk_step,
)
from tests.unit.test_klein import empirical_dist, enumerate_target, tvd_dicts

N, B, N_PAD = 136, 256, 256
SIGMA, SIGMA_PROP = 0.6, 0.3
# the MH components are sums of 136 float32 terms: Pallas Kahan-sums them
# in float32, the port sums in float64; 1e-3 absolute is rounding margin
# for sums of order 10 to 100 that still catches any wrong term
ATOL = 1e-3
# chains whose proposal differs by a float32 CDF-boundary tie (Pallas sums
# the coupling in bf16 pieces, the port in FP32): each first off by one
MAX_TIE_CHAINS = 0.05
BASIS_2D = np.array([[1.0, 0.5], [0.0, 1.0]])
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
    pre = j_pre(j_lfb(basis, dtype=jnp.float64), SIGMA, center=center)
    d = {k: np.asarray(getattr(pre, k))
         for k in ("basis", "U", "cs", "sigmas", "sigma")}
    d.update(window=pre.window, clamped=pre.clamped)
    return pre, klein_precomp_from_numpy(d, device="cpu")


def _tie_chains(got, want):
    """Chains (rows of (B, n)) that differ; each first differs, in its
    highest coordinate (drawn first), by exactly one."""
    diff = got != want
    ties = diff.any(axis=1)
    assert ties.mean() <= MAX_TIE_CHAINS, ties.sum()
    for b in np.flatnonzero(ties):
        first = np.flatnonzero(diff[b]).max()
        assert abs(got[b, first] - want[b, first]) == 1, (b, first)
    return ties


def test_operands_follow_the_pallas_wrapper(pres):
    """Proposal widths sigma_i sigma_p / sigma; the window by the tail
    budget 0.01 on that proposal profile (smk_pallas.py:487-493)."""
    from lattice_gaussian_mcmc_tpu.samplers.klein import (
        suggest_window_budget,
    )
    pre, pre_t = pres
    ops = smk_cuda.smk_operands(pre_t, SIGMA_PROP)
    prof = np.asarray(pre.sigmas) * (SIGMA_PROP / SIGMA)
    assert ops.window == suggest_window_budget(prof, 0.01)
    assert ops.n == N and ops.n_pad == N_PAD
    np.testing.assert_allclose(1.0 / ops.isgp[:N].numpy(), prof, rtol=1e-6)
    np.testing.assert_allclose(ops.wqt[:N].numpy(),
                               1.0 / (np.asarray(pre.sigmas) * np.sqrt(2)),
                               rtol=1e-6)
    assert float(ops.wqt[N:].abs().sum()) == 0.0


def test_b4_plain_matches_pallas_debug(pres):
    pre, pre_t = pres
    key = jax.random.key(21)
    with jax.experimental.pallas.tpu.force_tpu_interpret_mode():
        X0, _ = klein_sample_batch_pallas(jax.random.fold_in(key, 1), pre,
                                          B, host_rng=True, tile=128)
    Xp, accp, dbg = smk_steps_batch_pallas(
        key, pre, X0, n_steps=1, sigma_prop=SIGMA_PROP, tile=128,
        interpret=True, host_rng=True, debug=True)
    # the wrapper's own uniforms (smk_pallas.py _smk_steps_jit)
    _, k_unif = jax.random.split(key)
    unif = np.array(jax.random.uniform(k_unif, (N_PAD + 8, B),
                                       dtype=jnp.float32))
    ops = smk_cuda.smk_operands(pre_t, SIGMA_PROP)
    kops = klein_cuda.kernel_operands(pre_t)
    x = klein_cuda.to_kernel_layout(kops, torch.tensor(np.asarray(X0)))
    acc = torch.zeros(B)
    x, acc, la, got = smk_cuda.smk_steps_plain(
        ops, x, acc, 1, uniforms=torch.from_numpy(unif), debug=True)
    # the proposals (recentered frame) agree up to ties
    prop = got["p"][:N].T.numpy()
    same = ~_tie_chains(prop, np.asarray(dbg["p"]))
    np.testing.assert_allclose(got["ctn"][:N].T.numpy()[same],
                               np.asarray(dbg["ctn"])[same], atol=1e-4)
    for k in ("lwf", "lwr", "qn", "qc", "log_alpha"):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(dbg[k])[same], atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(acc.numpy()[same], np.asarray(accp)[same])
    X = klein_cuda.from_kernel_layout(kops, x).numpy()
    np.testing.assert_array_equal(X[same], np.asarray(Xp)[same])
    torch.testing.assert_close(la, got["log_alpha"])
    assert 0 < float(acc.sum()) < B          # both outcomes occur


def test_b4_plain_matches_smk_step_2d_hard_regime():
    """Decision by decision: the plain kernel's recentered identities
    (reverse centres, proposal ratio as a difference of log-normaliser
    sums, target quadratics) against `smk_step`, which evaluates both
    Klein densities and the target directly, on the same Philox stream."""
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    s = MetropolisKleinSampler(lat, 0.35, proposal_sigma=0.35, device="cpu")
    ops, kops = s.operands, s.klein_operands
    pre_h = dataclasses.replace(s.pre, window=ops.window)
    C, K = 4096, 6
    x, _ = klein_cuda.klein_draw(kops, C, seed=2, step=0)
    X0 = klein_cuda.from_kernel_layout(kops, x).double()
    acc = torch.zeros(C)
    smk_cuda.smk_steps(ops, x, acc, K, seed=2, step=1)
    st = ChainState(coeffs=X0, log_w=torch.zeros(C, dtype=torch.float64),
                    accepted=torch.zeros(C, dtype=torch.int32), steps=0)
    for _ in range(K):
        st = smk_step(st, pre_h, s._Q, s._R, seed=2)
    torch.testing.assert_close(klein_cuda.from_kernel_layout(kops, x).double(),
                               st.coeffs, rtol=0, atol=0)
    torch.testing.assert_close(acc.to(torch.int32), st.accepted)
    rate = float(acc.sum()) / (C * K)
    assert 0.05 < rate < 0.95, rate


def test_klein_log_density_matches_jax(pres):
    pre, pre_t = pres
    rng = np.random.default_rng(8)
    X = np.round(np.asarray(pre.cs) + rng.normal(scale=0.5, size=(16, N)))
    np.testing.assert_allclose(
        klein_log_density(torch.from_numpy(X), pre_t).numpy(),
        np.asarray(j_log_density(jnp.asarray(X), pre)), rtol=1e-12)


@pytest.mark.parametrize("route", ["chain", "iid"])
def test_smk_law_2d_hard_regime(route):
    """The plain SMK chain (`sample`, trajectory semantics) and
    `sample_iid` (B1 then B4's plain version) meet the reference's TVD
    gate against the enumerated target."""
    lat = lattice_from_basis(BASIS_2D, device="cpu")
    s = SMKSampler(lat, 0.35, proposal_sigma=0.35, device="cpu")
    if route == "chain":
        X = s.sample(9, 2, thin=2, burn_in=6, n_chains=16_384,
                     return_coeffs=True)
        assert X.shape == (32_768, 2)
    else:
        X = s.sample_iid(9, 32_768, n_steps=6, return_coeffs=True)
    target = enumerate_target(BASIS_2D, 0.35, np.zeros(2), radius=15)
    assert tvd_dicts(empirical_dist(X.numpy()), target) < TVD_GATE
    assert 0.05 < s.acceptance_rate < 0.95


def test_sample_iid_backend_routing():
    lat = lattice_from_basis(np.eye(2), device="cpu")
    s = SMKSampler(lat, 2.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        s.sample_iid(0, 8, n_steps=1, backend="cuda")
    with pytest.raises(ValueError):
        s.sample_iid(0, 8, n_steps=1, backend="pallas")
