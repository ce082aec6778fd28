"""The CUDA kernels B1 (Klein draw) and B2 (fused IMHK) against their plain
PyTorch versions on the card. These need a CUDA device and skip without
one; they import nothing of JAX, so on a machine with a card and no JAX run

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(`chip_smoke.py` makes the same checks at the flagship's shapes)."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    klein_precompute,
)

N, B = 136, 2048
# float32 CDF-boundary ties between the kernel and its plain version (the
# coupling sums run in another order) flip a draw by one and re-route the
# rest of that chain; at most this share of chains may do so
MAX_CHAINS_DIFFERING = 0.02
# log-weights of chains that agree: 136 float32 log-normalizers, rounding
LW_ATOL = 1e-4


def _operands(window=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(136)
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cuda")
    pre = klein_precompute(lat, 0.6, center=rng.normal(scale=10.0, size=N),
                           window=window)
    return klein_cuda.kernel_operands(pre)


@pytest.fixture
def ops():
    return _operands()


def _agree(y, yp, lw, lwp):
    same = (y[:N] == yp[:N]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    torch.testing.assert_close(lw[same], lwp[same], atol=LW_ATOL, rtol=0)


@pytest.mark.cuda
def test_b1_matches_plain_host_uniforms_and_philox(ops):
    unif = torch.rand(ops.n_pad, B, device="cuda")
    y, lw = klein_cuda.klein_draw(ops, B, uniforms=unif)
    yp, lwp = klein_cuda.klein_draw_plain(ops, B, uniforms=unif)
    _agree(y, yp, lw, lwp)
    y, lw = klein_cuda.klein_draw(ops, B, seed=9, step=4)
    yp, lwp = klein_cuda.klein_draw_plain(ops, B, seed=9, step=4)
    _agree(y, yp, lw, lwp)


@pytest.mark.cuda
def test_b1_runtime_window_matches_plain():
    """A window other than the compiled 16 takes the runtime-window
    path."""
    ops = _operands(window=40)
    y, lw = klein_cuda.klein_draw(ops, B, seed=2, step=1)
    yp, lwp = klein_cuda.klein_draw_plain(ops, B, seed=2, step=1)
    _agree(y, yp, lw, lwp)


@pytest.mark.cuda
def test_b2_matches_plain(ops):
    y, lw = klein_cuda.klein_draw(ops, B, seed=9, step=0)
    x, l, a = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lp, ap = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, l, a, 2, seed=9, step=1)
    klein_cuda.imhk_fused_plain(ops, xp, lp, ap, 2, seed=9, step=1)
    _agree(x, xp, l, lp)
    assert (a != ap).float().mean().item() <= MAX_CHAINS_DIFFERING
    assert 0 < a.sum().item() < 2 * B


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(ops):
    klein_cuda.reset_launch_counts()
    y, lw = klein_cuda.klein_draw(ops, 256, seed=1)
    klein_cuda.imhk_fused(ops, y, lw, torch.zeros_like(lw), 3, seed=1,
                          step=1)
    assert klein_cuda.klein_draw.launches == 1
    assert klein_cuda.imhk_fused.launches == 1
    with pytest.raises(ValueError, match="shape"):
        klein_cuda.klein_draw(ops, 256, uniforms=torch.rand(8, 256,
                                                            device="cuda"))
    assert klein_cuda.klein_draw.launches == 1


@pytest.mark.cuda
def test_sample_iid_on_card_hard_regime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    s = IMHKSampler(lat, 0.35, burn_in=12, device="cuda")
    X = s.sample_iid(3, 65_536, return_coeffs=True, backend="cuda")
    assert X.shape == (65_536, 2) and X.is_cuda
    # enumerated stationary acceptance of this regime
    assert abs(s.acceptance_rate - 0.9904) < 0.01
