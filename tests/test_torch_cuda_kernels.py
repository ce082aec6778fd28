"""The CUDA kernels B1 (Klein draw), B2 (fused IMHK), B3 (IMHK trajectory),
B4 (fused SMK) and B5 (Peikert) against their plain PyTorch versions on the
card. These need a CUDA device and skip without
one; they import nothing of JAX, so on a machine with a card and no JAX run

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(`chip_smoke.py` makes the same checks at the flagship's shapes)."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    peikert_cuda,
    smk_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    PeikertSampler,
    SMKSampler,
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


@pytest.mark.cuda
def test_b3_is_b2_with_a_ring(ops):
    """One code path: B3's final state is B2's bit for bit, and its ring
    holds B2's state and lw after every thin-th step."""
    y, lw = klein_cuda.klein_draw(ops, B, seed=4, step=0)
    x3, l3, a3 = y.clone(), lw.clone(), torch.zeros_like(lw)
    x3, l3, a3, tx, tlw = klein_cuda.imhk_trajectory(
        ops, x3, l3, a3, 3, 2, seed=4, step=1, coeffs=True)
    x2, l2, a2 = y.clone(), lw.clone(), torch.zeros_like(lw)
    n_pad = ops.n_pad
    for k in range(3):
        klein_cuda.imhk_fused(ops, x2, l2, a2, 2, seed=4, step=1 + 2 * k)
        assert torch.equal(tlw[k], l2)
        assert torch.equal(tx[k * n_pad:(k + 1) * n_pad], x2)
    assert torch.equal(x3, x2) and torch.equal(l3, l2)
    assert torch.equal(a3, a2)
    assert 0 < a3.sum().item() < 6 * B


@pytest.mark.cuda
def test_b4_matches_plain_2d_hard_regime():
    """Decision by decision where SMK rejects often."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    s = SMKSampler(lat, 0.35, proposal_sigma=0.35, device="cuda")
    y, _ = klein_cuda.klein_draw(s.klein_operands, 8192, seed=3)
    x, a = y.clone(), torch.zeros(8192, device="cuda")
    xp, ap = y.clone(), torch.zeros(8192, device="cuda")
    _, _, la = smk_cuda.smk_steps(s.operands, x, a, 4, seed=3, step=1)
    _, _, lap = smk_cuda.smk_steps_plain(s.operands, xp, ap, 4, seed=3,
                                         step=1)
    same = (x[:2] == xp[:2]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    assert torch.equal(a[same], ap[same])
    assert 0 < a.sum().item() < 4 * 8192
    torch.testing.assert_close(la[same], lap[same], atol=LW_ATOL, rtol=0)
    smk_cuda.reset_launch_counts()
    s.sample_iid(5, 1024, n_steps=2, backend="cuda")
    assert smk_cuda.smk_steps.launches == 1


@pytest.mark.cuda
def test_b5_matches_plain_on_host_normals():
    """Rows are independent: a CDF-boundary tie moves one coordinate by one
    and nothing else. n = 136 pads to 192 rows of whole Box-Muller pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    basis = np.triu(rng.uniform(-0.5, 0.5, (N, N))) + np.eye(N)
    lat = lattice_from_basis(basis, device="cuda")
    s = PeikertSampler(lat, 3.0 * float(np.linalg.norm(basis, 2)),
                       device="cuda")
    ops = s.operands
    assert ops.n_pad == 192
    z = torch.randn(2 * ops.n_pad, B, device="cuda")
    u = torch.rand(2 * ops.n_pad, B, device="cuda")
    for kw in ({"normals": z, "uniforms": u}, {"seed": 6}):
        ring = peikert_cuda.peikert_rounds(ops, B, 2, **kw)
        ringp = peikert_cuda.peikert_rounds_plain(ops, B, 2, **kw)
        diff = ring != ringp
        assert diff.float().mean().item() <= 1e-3
        assert bool(((ring - ringp).abs()[diff] == 1).all())
        assert bool(torch.isfinite(ring).all())
