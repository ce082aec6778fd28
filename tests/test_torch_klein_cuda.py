"""The port's Klein kernels (B1 draw, B2 fused IMHK) held to the Pallas
kernel at stream level: the same host uniforms go through
`klein_sample_batch_pallas` / `imhk_step_pallas_fused` in interpret mode and
through the port's plain versions, and the integer coefficients, accept
decisions and log-weights must agree. n = 136 pads to 256 rows, so the
draw crosses two 128-row blocks (four of the port's 64-row blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    imhk_step_pallas_fused,
    klein_sample_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precomp_from_numpy

N, B = 136, 256
N_PAD = 256
# lw is a sum of 136 float32 log-normalizers. The Pallas kernel takes one
# log per 8-row group of the product of totals and Kahan-sums in float32;
# the port takes one log per row and sums in float64. Both are rounding
# noise of ~1e-7 per row, so 1e-4 absolute is a wide margin that still
# catches any wrong term (each log Z_i is O(1)).
LW_ATOL = 1e-4
# A CDF-boundary tie (u * total within float32 rounding of a partial sum)
# can flip one draw by +-1 when the two implementations round the centre or
# the CDF in another order. Every
# later row of that chain is then drawn around another centre, so such a
# chain is compared only down to its tie: at most this share of the chains
# may differ, and each such chain first differs by exactly 1. Pallas sums
# the coupling in bf16 pieces and the CDF as a matrix product, so ties are
# more frequent than between the port's kernel and its plain version: 0 of
# 256 chains in the B1 test, 6 of 256 over the two B2 steps.
MAX_TIE_CHAINS = 0.05


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
    lat = lattice_from_basis(basis, dtype=jnp.float64)
    # conditional widths 0.3-0.6: the hard regime, where MH rejects
    sigma = 0.6
    pre = klein_precompute(lat, sigma, center=center)
    d = {k: np.asarray(getattr(pre, k))
         for k in ("basis", "U", "cs", "sigmas", "sigma")}
    d.update(window=pre.window, clamped=pre.clamped)
    return pre, klein_precomp_from_numpy(d, device="cpu")


def _tie_chains(got, want):
    """Chains (rows of (B, n) coefficients) that differ; each must differ
    first, in its highest coordinate (drawn first), by exactly 1."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    ties = diff.any(axis=1)
    assert ties.mean() <= MAX_TIE_CHAINS, ties.sum()
    for b in np.flatnonzero(ties):
        first = np.flatnonzero(diff[b]).max()
        assert abs(got[b, first] - want[b, first]) == 1, (b, first)
    return ties


def test_operands_match_pallas_recentering(pres):
    from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
        _kernel_operands,
    )
    from lattice_gaussian_mcmc_tpu.samplers.klein_blocked import (
        _pad_precomp,
    )
    pre, pre_t = pres
    ppre, _ = _pad_precomp(pre, 128)
    _, _, _, _, cs, isg, k = _kernel_operands(ppre)
    ops = klein_cuda.kernel_operands(pre_t)
    assert ops.n_pad == N_PAD and ops.n == N
    np.testing.assert_array_equal(ops.shift.numpy(), np.asarray(k))
    # cs_eff: the port forms it in float64, Pallas in float32 (|cs| ~ 10)
    np.testing.assert_allclose(ops.cs.numpy(), np.asarray(cs)[0],
                               atol=1e-5)
    np.testing.assert_allclose(ops.isg.numpy(), np.asarray(isg)[0],
                               rtol=1e-7)


def test_b1_plain_matches_pallas_stream(pres):
    pre, pre_t = pres
    key = jax.random.key(5)
    with pltpu.force_tpu_interpret_mode():
        Xp, lwp = klein_sample_batch_pallas(key, pre, B, host_rng=True,
                                            tile=128)
    # the wrapper's own uniforms (klein_pallas.py klein_sample_batch_pallas)
    _, k_unif = jax.random.split(key)
    unif = np.array(jax.random.uniform(k_unif, (N_PAD, B),
                                        dtype=jnp.float32))
    ops = klein_cuda.kernel_operands(pre_t)
    y, lw = klein_cuda.klein_draw(ops, B, uniforms=torch.from_numpy(unif))
    X = klein_cuda.from_kernel_layout(ops, y)
    assert X.shape == (B, N) and lw.dtype == torch.float32
    same = ~_tie_chains(X.numpy(), Xp)
    np.testing.assert_allclose(lw.numpy()[same], np.asarray(lwp)[same],
                               atol=LW_ATOL)


def test_b2_plain_matches_pallas_stream(pres):
    pre, pre_t = pres
    key = jax.random.key(6)
    with pltpu.force_tpu_interpret_mode():
        X0, lw0 = klein_sample_batch_pallas(key, pre, B, host_rng=True,
                                            tile=128)
        acc0 = jnp.zeros((B,), jnp.float32)
        k2 = jax.random.fold_in(key, 1)
        Xp, lwp, accp = imhk_step_pallas_fused(k2, pre, X0, lw0, acc0,
                                               tile=128, n_steps=2,
                                               interpret=True, host_rng=True)
    _, k_unif = jax.random.split(k2)
    unif = np.array(jax.random.uniform(
        k_unif, (2 * (N_PAD + 8), B), dtype=jnp.float32))
    ops = klein_cuda.kernel_operands(pre_t)
    x = klein_cuda.to_kernel_layout(ops, torch.tensor(np.asarray(X0)))
    lw = torch.tensor(np.asarray(lw0, dtype=np.float32))
    acc = torch.zeros(B)
    klein_cuda.imhk_fused(ops, x, lw, acc, 2,
                          uniforms=torch.from_numpy(unif))
    X = klein_cuda.from_kernel_layout(ops, x)
    # The Pallas interpreter does not carry the aliased state buffer into
    # the kernel, so a chain that rejects both proposals comes back as NaN
    # there. The port must have kept that chain's starting state.
    Xp = np.array(Xp)
    lost = np.isnan(Xp).any(axis=1)
    assert np.all(acc.numpy()[lost] == 0)
    np.testing.assert_array_equal(X.numpy()[lost], np.asarray(X0)[lost])
    Xp[lost] = X.numpy()[lost]
    same = ~_tie_chains(X.numpy(), Xp)
    np.testing.assert_array_equal(acc.numpy()[same], np.asarray(accp)[same])
    np.testing.assert_allclose(lw.numpy()[same], np.asarray(lwp)[same],
                               atol=LW_ATOL)
    assert 0 < float(acc.sum()) < 2 * B   # both outcomes occur


def test_philox_draw_is_batch_independent(pres):
    """In-kernel-style Philox: chain i's draw does not depend on the batch
    it is drawn in, and a chain offset addresses the same stream."""
    _, pre_t = pres
    ops = klein_cuda.kernel_operands(pre_t)
    y_all, lw_all = klein_cuda.klein_draw(ops, 64, seed=3, step=2)
    y_tail, lw_tail = klein_cuda.klein_draw(ops, 32, seed=3, step=2,
                                            chain_offset=32)
    torch.testing.assert_close(y_tail, y_all[:, 32:], rtol=0, atol=0)
    torch.testing.assert_close(lw_tail, lw_all[32:], rtol=0, atol=0)


def test_wrappers_reject_bad_cuda_operands(pres):
    """The kernel path validates device and shape before any launch."""
    _, pre_t = pres
    ops = klein_cuda.kernel_operands(pre_t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        klein_cuda._check_operands(ops)
