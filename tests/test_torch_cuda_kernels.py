"""The CUDA kernels B1 (Klein draw), B6 (Klein ring) and B7 (Babai; all
three from `csrc/klein_tc.cu`, and from `csrc/klein.cu` above n_pad
3,456), B2 (fused IMHK), B3 (IMHK trajectory; B2 and B3 from
`csrc/imhk_tc.cu`), B4 (fused SMK, `csrc/smk_tc.cu`), B5 (Peikert,
`csrc/peikert_tc.cu`) and B8 (Z^n, `csrc/zn.cu`), and the lattice
points' int8 kernel (`csrc/points.cu`, against the float64 DGEMM), against their plain
PyTorch versions on the card, and the entry points that must reach them. These need a CUDA device and skip without
one; they import nothing of JAX, so on a machine with a card and no JAX run

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(`chip_smoke.py` makes the same checks at the flagship's shapes)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    lattice_from_numpy,
    ntru_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops import linalg
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    launch_record,
    peikert_cuda,
    smk_cuda,
    zn_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    KleinSampler,
    PeikertSampler,
    SMKSampler,
    UnifiedLatticeSampler,
    identity_lattice,
    klein_precompute,
    sample_zn,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 136, 2048
# float32 CDF-boundary ties between the kernel and its plain version (the
# coupling sums run in another order) flip a draw by one and re-route the
# rest of that chain; at most this share of chains may do so
MAX_CHAINS_DIFFERING = 0.02
# log-weights of chains that agree: 136 float32 log-normalizers, rounding
LW_ATOL = 1e-4


def _rec(kernel, field="launches"):
    """`field` of `kernel` in the launch record."""
    return launch_record.read()[kernel][field]


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


# FALCON-512 and FALCON-1024 at their signing sigma, window by tail budget
# 0.01 (the IMHK cells' operands): ring degree -> sigma, n_pad, window
FALCON = {512: (165.7366, 1024, 16), 1024: (168.3886, 2048, 24)}
# a chain count that is not a multiple of the 32 chains a block holds
ODD_CHAINS = 997
# B2/B3's residency (imhk_tc.cu): eight blocks of 32 chains an SM
MIN_RESIDENT_CHAINS = 256
# lw at n = 1024 and 2048 sums float32 log-normalizers to ~10^3, where a
# float32 ulp is 1.2e-4 to 2.4e-4 (chip_smoke.py MAX_LW_ERR)
FALCON_LW_ATOL = 1e-3


def _falcon_operands(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sigma, n_pad, window = FALCON[ring]
    lat = ntru_lattice(ring, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    ops = klein_cuda.kernel_operands(
        klein_precompute(lat, sigma, tail_budget=0.01))
    assert (ops.n_pad, ops.window) == (n_pad, window)
    return ops


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
    """A window other than the compiled 8, 16 and 24 takes the
    runtime-window path."""
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
@pytest.mark.parametrize("ring", [512, 1024])
def test_b2_matches_plain_at_the_falcon_widths(ring):
    """n_pad 1024 at W 16 and n_pad 2048 at W 24, on a chain count that
    leaves the last block part empty."""
    ops = _falcon_operands(ring)
    launch_record.reset()
    y, lw = klein_cuda.klein_draw(ops, ODD_CHAINS, seed=3)
    x, l, a = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lp, ap = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, l, a, 2, seed=3, step=1)
    klein_cuda.imhk_fused_plain(ops, xp, lp, ap, 2, seed=3, step=1)
    assert _rec("imhk_fused") == 1
    same = (x[:ops.n] == xp[:ops.n]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    torch.testing.assert_close(l[same], lp[same], atol=FALCON_LW_ATOL,
                               rtol=0)
    assert (a != ap).float().mean().item() <= MAX_CHAINS_DIFFERING
    assert a.sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [512, 1024])
def test_b2_b3_record_their_residency(ring):
    """Each launch records the chains an SM held, the kernel's own
    occupancy: eight blocks of 32 chains at both FALCON widths."""
    ops = _falcon_operands(ring)
    launch_record.reset()
    y, lw = klein_cuda.klein_draw(ops, 64, seed=1)
    klein_cuda.imhk_fused(ops, y, lw, torch.zeros_like(lw), 1, seed=1,
                          step=1)
    klein_cuda.imhk_trajectory(ops, y, lw, torch.zeros_like(lw), 1,
                               seed=1, step=2)
    res = klein_cuda.imhk_tc_resources(ops.n_pad, ops.window)
    assert _rec("imhk_fused", "resident_chains") == res["resident_chains"]
    assert (_rec("imhk_trajectory", "resident_chains")
            == res["resident_chains"])
    assert res["resident_chains"] >= MIN_RESIDENT_CHAINS
    assert res["registers"] <= 128


@pytest.mark.cuda
def test_b2_matches_plain_decisions_2d_hard_regime():
    """Decision by decision where IMHK rejects (~1% of proposals), on the
    caller's uniforms: every chain that agrees in state made the plain
    version's decisions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    ops = IMHKSampler(lat, 0.35, burn_in=12, device="cuda").operands
    chains, steps = 16_384, 4
    y, lw = klein_cuda.klein_draw(ops, chains, seed=8)
    u = torch.rand(steps * (ops.n_pad + klein_cuda.ACCEPT_ROWS), chains,
                   device="cuda")
    x, l, a = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lp, ap = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, l, a, steps, uniforms=u)
    klein_cuda.imhk_fused_plain(ops, xp, lp, ap, steps, uniforms=u)
    same = (x[:2] == xp[:2]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    assert torch.equal(a[same], ap[same])
    torch.testing.assert_close(l[same], lp[same], atol=LW_ATOL, rtol=0)
    assert 0 < steps * chains - a.sum().item() < 0.05 * steps * chains


@pytest.mark.cuda
def test_b2_b3_raise_beyond_the_exact_range():
    """Hazard C8: a proposal coefficient with |y| > 256 is not exact in the
    narrow instantiation's bf16 tile, so the wrapper raises where the
    operands predict narrow draws (`wide_y`) and a draw passes 256
    (`far_operands`). Near 200 it runs and reports the range; a centre of
    300 is predicted (fault C11) and runs on the WIDE instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chains = 256

    def state(ops):
        return (torch.zeros(ops.n_pad, chains, device="cuda"),
                torch.zeros(chains, device="cuda"),
                torch.zeros(chains, device="cuda"))

    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 0.35))
    for centre, wide in ((200.0, False), (300.0, True)):
        ops.cs[0] = centre       # the recentred centre of row 0
        assert klein_cuda.wide_y(ops) == wide
        x, lw, acc = state(ops)
        launch_record.reset()
        klein_cuda.imhk_fused(ops, x, lw, acc, 1, seed=1)
        assert centre - 5 <= _rec("imhk_fused", "max_abs_y") <= centre + 5
    far = klein_cuda.kernel_operands(klein_precompute(far_lattice(), 0.02))
    far_centres(far)
    x, lw, acc = state(far)
    with pytest.raises(RuntimeError, match="C8"):
        klein_cuda.imhk_fused(far, x, lw, acc, 1, seed=1)
    with pytest.raises(RuntimeError, match="C8"):
        klein_cuda.imhk_trajectory(far, x, lw, acc, 2, seed=1)


def far_lattice():
    """[[1, 1000], [0, 1]]: U's 1000 carries row 1's draw into row 0."""
    return lattice_from_basis(np.array([[1.0, 1000.0], [0.0, 1.0]]),
                              device="cuda")


def far_centres(ops):
    """Recentred centres (500, 0.5) at sigma 0.02: row 1 draws 0 or 1,
    which puts row 0 at +-500, though row 0's predicted mean is 0 and its
    spread ~20, so `wide_y` predicts narrow draws."""
    ops.cs[0], ops.cs[1] = 500.0, 0.5
    assert not klein_cuda.wide_y(ops)


@pytest.mark.cuda
def test_b2_b3_raise_above_their_largest_n_pad():
    """The proposal tile bounds n_pad; above IMHK_TC_MAX_N_PAD the wrapper
    names the limit before it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_pad = klein_cuda.IMHK_TC_MAX_N_PAD + klein_cuda.BLOCK
    eye = torch.eye(n_pad, device="cuda")
    zeros = torch.zeros(n_pad, device="cuda")
    ops = klein_cuda.KleinOperands(U=eye, UT=eye, cs=zeros, isg=zeros + 1,
                                   shift=zeros, n=n_pad, window=16)
    x = torch.zeros(n_pad, 32, device="cuda")
    lw, acc = torch.zeros(32, device="cuda"), torch.zeros(32, device="cuda")
    launch_record.reset()
    with pytest.raises(ValueError, match=str(klein_cuda.IMHK_TC_MAX_N_PAD)):
        klein_cuda.imhk_fused(ops, x, lw, acc, 1, seed=1)
    with pytest.raises(ValueError, match=str(klein_cuda.IMHK_TC_MAX_N_PAD)):
        klein_cuda.imhk_trajectory(ops, x, lw, acc, 1, seed=1)
    assert _rec("imhk_fused") == 0


@pytest.mark.cuda
def test_sample_reads_the_c8_guard_once():
    """The entry points pass one guard to every launch and raise from it
    before they return, here on draws past 256 that the operands did not
    predict (`far_centres`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = IMHKSampler(far_lattice(), 0.02, burn_in=3, device="cuda")
    far_centres(s.operands)
    with pytest.raises(RuntimeError, match="IMHKSampler.sample_iid.*C8"):
        s.sample_iid(1, 256, return_coeffs=True)
    with pytest.raises(RuntimeError, match="IMHKSampler.sample.*C8"):
        s.sample(1, 2, n_chains=256, return_coeffs=True)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(ops):
    launch_record.reset()
    y, lw = klein_cuda.klein_draw(ops, 256, seed=1)
    klein_cuda.imhk_fused(ops, y, lw, torch.zeros_like(lw), 3, seed=1,
                          step=1)
    assert _rec("klein_draw") == 1
    assert _rec("imhk_fused") == 1
    with pytest.raises(ValueError, match="shape"):
        klein_cuda.klein_draw(ops, 256, uniforms=torch.rand(8, 256,
                                                            device="cuda"))
    assert _rec("klein_draw") == 1


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
@pytest.mark.parametrize("width", ["n136", 512, 1024])
def test_b3_is_b2_with_a_ring(width):
    """One code path: B3's final state is B2's bit for bit, and its ring
    holds B2's state and lw after every thin-th step; on the small
    operands and at both FALCON widths."""
    ops = _operands() if width == "n136" else _falcon_operands(width)
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
    assert 0 < a3.sum().item() <= 6 * B
    if width == "n136":
        # FALCON's sigma rejects ~3e-5 of proposals; these operands reject
        assert a3.sum().item() < 6 * B


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
    launch_record.reset()
    s.sample_iid(5, 1024, n_steps=2, backend="cuda")
    assert _rec("smk_steps") == 1


@pytest.mark.cuda
def test_b4_raises_beyond_the_exact_range_and_its_largest_n_pad():
    """Hazard C8 for B4: a state or proposal coefficient with |y| > 256 is
    not exact in bf16, so the wrapper (or SMKSampler.sample_iid, reading
    its one guard) raises; at 200 it runs and reports the range. Above
    SMK_TC_MAX_N_PAD the wrapper names the limit before it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    s = SMKSampler(lat, 0.35, proposal_sigma=0.35, device="cuda")
    ops = s.operands
    chains = 256
    for value, raises in ((200.0, False), (256.0, True), (300.0, True)):
        # at 256 the state is exact but proposals step to 257
        x = torch.zeros(ops.n_pad, chains, device="cuda")
        x[0] = value
        acc = torch.zeros(chains, device="cuda")
        launch_record.reset()
        if raises:
            with pytest.raises(RuntimeError, match="smk_steps.*C8"):
                smk_cuda.smk_steps(ops, x, acc, 4, seed=1)
        else:
            smk_cuda.smk_steps(ops, x, acc, 4, seed=1)
            assert 195 <= _rec("smk_steps", "max_abs_y") <= 205
    s.klein_operands.cs[0] = 300.0   # the Klein start's row 0 beyond 256
    with pytest.raises(RuntimeError, match="SMKSampler.sample_iid.*C8"):
        s.sample_iid(1, chains, n_steps=2, return_coeffs=True)
    n_pad = smk_cuda.SMK_TC_MAX_N_PAD + klein_cuda.BLOCK
    eye = torch.eye(n_pad, device="cuda")
    zeros = torch.zeros(n_pad, device="cuda")
    big = smk_cuda.SMKOperands(U=eye, UT=eye, cse=zeros, isgp=zeros + 1,
                               wqt=zeros, shift=zeros, n=n_pad, window=8)
    x = torch.zeros(n_pad, 32, device="cuda")
    launch_record.reset()
    with pytest.raises(ValueError, match=str(smk_cuda.SMK_TC_MAX_N_PAD)):
        smk_cuda.smk_steps(big, x, torch.zeros(32, device="cuda"), 1)
    assert _rec("smk_steps") == 0


@pytest.mark.cuda
def test_b4_b5_runtime_window_match_plain():
    """A window other than the compiled 8, 16 and 24 takes B4's and B5's
    runtime-window path: B4 decision by decision in the 2D hard regime,
    B5 up to ties on the caller's normals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    s = SMKSampler(lat, 0.35, proposal_sigma=0.35, device="cuda")
    ops = dataclasses.replace(s.operands, window=12)
    y, _ = klein_cuda.klein_draw(s.klein_operands, 8192, seed=3)
    x, a = y.clone(), torch.zeros(8192, device="cuda")
    xp, ap = y.clone(), torch.zeros(8192, device="cuda")
    smk_cuda.smk_steps(ops, x, a, 4, seed=3, step=1)
    smk_cuda.smk_steps_plain(ops, xp, ap, 4, seed=3, step=1)
    same = (x[:2] == xp[:2]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    assert torch.equal(a[same], ap[same])
    assert 0 < a.sum().item() < 4 * 8192
    rng = np.random.default_rng(5)
    basis = np.triu(rng.uniform(-0.5, 0.5, (N, N))) + np.eye(N)
    lp = lattice_from_basis(basis, device="cuda")
    pk = PeikertSampler(lp, 3.0 * float(np.linalg.norm(basis, 2)),
                        device="cuda")
    opp = peikert_cuda.peikert_operands(pk.pre, window=40)
    z = torch.randn(opp.n_pad, B, device="cuda")
    u = torch.rand(opp.n_pad, B, device="cuda")
    ring = peikert_cuda.peikert_rounds(opp, B, 1, uniforms=u, normals=z)
    ringp = peikert_cuda.peikert_rounds_plain(opp, B, 1, uniforms=u,
                                              normals=z)
    diff = ring != ringp
    assert diff.float().mean().item() <= 1e-3
    assert bool(((ring - ringp).abs()[diff] == 1).all())


def _peikert_row():
    """PeikertSampler at the Peikert row's operands: NTRU-512 (dimension
    1024), sigma 1.05 r s1(B)."""
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    s1 = float(np.linalg.norm(lat.basis.cpu().numpy(), 2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    return PeikertSampler(lat, 1.05 * r * s1, device="cuda"), r


@pytest.mark.cuda
def test_b5_matches_plain_at_the_peikert_row():
    """At dimension 1024, window 24: on the caller's normals and on
    Philox, coordinates differ only by ties, each by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, _ = _peikert_row()
    ops = s.operands
    assert (ops.n_pad, ops.window) == (1024, 24)
    z = torch.randn(2 * ops.n_pad, B, device="cuda")
    u = torch.rand(2 * ops.n_pad, B, device="cuda")
    for kw in ({"normals": z, "uniforms": u}, {"seed": 6}):
        ring = peikert_cuda.peikert_rounds(ops, B, 2, **kw)
        ringp = peikert_cuda.peikert_rounds_plain(ops, B, 2, **kw)
        diff = ring != ringp
        assert diff.float().mean().item() <= 1e-3
        assert bool(((ring - ringp).abs()[diff] == 1).all())


@pytest.mark.cuda
def test_b5_centres_within_the_gate_of_float64():
    """B5's debug instantiation: its own centres c = c' - L2 z (3xTF32 on
    the tensor cores) within 2e-3 r of float64 (hazard C9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, r = _peikert_row()
    ops = s.operands
    z = torch.randn(ops.n_pad, B, device="cuda")
    u = torch.rand(ops.n_pad, B, device="cuda")
    c, ring = peikert_cuda.peikert_centres(ops, B, uniforms=u, normals=z)
    n = ops.n
    c64 = (s.pre.cprime.double()[:, None]
           - s.pre.L2.double() @ z[:n].double())
    assert float((c[:n].double() - c64).abs().max()) / r <= 2e-3
    assert torch.equal(ring, peikert_cuda.peikert_rounds(
        ops, B, 1, uniforms=u, normals=z))


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


@pytest.mark.cuda
def test_b6_rounds_are_b1_draws(ops):
    """One code path: round r of the ring is B1's draw at step `step + r`,
    bit for bit; against the plain version up to ties."""
    ring, lw = klein_cuda.klein_ring(ops, B, 3, seed=5, step=1)
    n_pad = ops.n_pad
    for r in range(3):
        y, l1 = klein_cuda.klein_draw(ops, B, seed=5, step=1 + r)
        assert torch.equal(ring[r * n_pad:(r + 1) * n_pad], y)
        assert torch.equal(lw[r], l1)
    ringp, lwp = klein_cuda.klein_ring_plain(ops, B, 3, seed=5, step=1)
    for r in range(3):
        sl = slice(r * n_pad, (r + 1) * n_pad)
        _agree(ring[sl], ringp[sl], lw[r], lwp[r])
    assert not torch.equal(ring[:n_pad], ring[n_pad:2 * n_pad])


@pytest.mark.cuda
def test_b7_matches_float64_and_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(136)
    basis = (np.triu(rng.uniform(-0.5, 0.5, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cuda")
    xs = torch.tensor(rng.integers(-2, 3, (B, N)), dtype=torch.float64,
                      device="cuda")
    t = xs @ lat.basis.T + 0.1 * torch.randn(B, N, dtype=torch.float64,
                                             device="cuda")
    launch_record.reset()
    X = lat.nearest_plane(t)
    assert _rec("babai_decode") == 1
    assert _rec("babai_decode", "fp32_launches") == 0
    assert klein_cuda.babai_y_stats()["beyond_256"] == 0
    assert torch.equal(X, xs)
    assert torch.equal(X, linalg.babai_nearest_plane(lat.Q, lat.R, t))
    # half-integer targets in 2D: decision for decision (rintf, C3)
    lat2 = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                              device="cuda")
    h = torch.randint(-40, 41, (B, 2), device="cuda").double() / 2
    ops2 = klein_cuda.babai_operands(lat2.Q, lat2.R)
    ct, _ = klein_cuda.babai_centres(ops2, h)
    assert torch.equal(klein_cuda.babai_decode(ops2, ct),
                       klein_cuda.babai_decode_plain(ops2, ct))


@pytest.mark.cuda
def test_b8_matches_plain_and_sample_zn_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    num = (1 << 20) + 3
    u = torch.rand(num, device="cuda")
    for kw in ({"uniforms": u}, {"seed": 3, "device": "cuda"}):
        # the kernel forms the plain version's CDF bit for bit: every draw
        # is equal, including a last group of three
        for W in (32, 100):
            z = zn_cuda.sample_zn_draws(num, 2.5, 0.5, W, **kw)
            zp = zn_cuda.sample_zn_draws_plain(num, 2.5, 0.5, W, **kw)
            assert torch.equal(z, zp)
    # a prefix of a longer run is the same draws
    z = zn_cuda.sample_zn_draws(num, 2.5, 0.5, 32, seed=3, device="cuda")
    assert torch.equal(zn_cuda.sample_zn_draws(
        1001, 2.5, 0.5, 32, seed=3, device="cuda"), z[:1001])
    launch_record.reset()
    Z = sample_zn(1, 64, 3.0, shape=(1000,), device="cuda")
    assert Z.shape == (1000, 64) and _rec("sample_zn_draws") == 1
    s = UnifiedLatticeSampler(identity_lattice(16, device="cuda"), sigma=2.0)
    s.sample(2, 100)
    assert _rec("sample_zn_draws") == 2


@pytest.mark.cuda
def test_b7_decodes_beyond_256_on_its_wide_parts():
    """`chip_smoke.py`'s reach basis: recentred coefficients pass 256 and
    2^16; B7 decodes x* coefficient for coefficient, as float64 and its
    plain version do, and counts the coefficients beyond 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    rng = np.random.default_rng(78)
    basis, xstar = chip_smoke.reach_basis(rng)
    n = basis.shape[0]
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(n), "R": basis,
                              "gs_norms": np.ones(n)}, device="cuda")
    xs = torch.from_numpy(xstar(200)).cuda()
    t = xs @ lat.basis.T + torch.from_numpy(
        rng.choice([-0.25, 0.25], (200, n))).cuda()
    launch_record.reset()
    X = lat.nearest_plane(t)
    assert torch.equal(X, xs)
    assert torch.equal(X, linalg.babai_nearest_plane(lat.Q, lat.R, t))
    stats = klein_cuda.babai_y_stats()
    assert _rec("babai_decode") == 1
    k = torch.round(t)
    y = xs - k
    assert stats["beyond_256"] == int((y.abs() > 256).sum()) > 0
    assert stats["max_abs_y"] == int(y.abs().max()) > 65536


@pytest.mark.cuda
def test_b7_fp32_route_above_the_tensor_core_reach():
    """Above n_pad 3,456 B7 takes klein.cu's FP32 sweep, counted apart,
    and matches the float64 nearest plane (dimension 3,500, its own R)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, T = 3500, 64
    rng = np.random.default_rng(35)
    basis = (np.triu(rng.uniform(-0.05, 0.05, (n, n)), 1)
             + np.diag(rng.uniform(1.0, 2.0, n)))
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(n), "R": basis,
                              "gs_norms": np.diag(basis)}, device="cuda")
    xs = torch.tensor(rng.integers(-2, 3, (T, n)), dtype=torch.float64,
                      device="cuda")
    t = xs @ lat.basis.T + 0.05 * torch.randn(T, n, dtype=torch.float64,
                                              device="cuda")
    launch_record.reset()
    X = lat.nearest_plane(t)
    assert (_rec("babai_decode"),
            _rec("babai_decode", "fp32_launches")) == (0, 1)
    assert torch.equal(X, xs)
    assert torch.equal(X, linalg.babai_nearest_plane(lat.Q, lat.R, t))


@pytest.mark.cuda
def test_klein_sampler_and_gibbs_reach_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    launch_record.reset()
    X = KleinSampler(lat, 2.0).sample(1, 4096, return_coeffs=True,
                                      backend="cuda")
    assert X.shape == (4096, 2) and _rec("klein_draw") == 1
    s = UnifiedLatticeSampler(lat, sigma=1.0)
    s.decode(2, torch.tensor([[0.3, 0.7], [1.2, -2.6]], device="cuda"),
             n_chains=4, n_sweeps=3)
    assert _rec("babai_decode") == 1


@pytest.mark.cuda
def test_b6_matches_plain_host_uniforms(ops):
    """B6 on the caller's uniforms (round r in rows r n_pad ..), every
    round against its plain version up to ties."""
    unif = torch.rand(3 * ops.n_pad, B, device="cuda")
    ring, lw = klein_cuda.klein_ring(ops, B, 3, uniforms=unif)
    ringp, lwp = klein_cuda.klein_ring_plain(ops, B, 3, uniforms=unif)
    for r in range(3):
        sl = slice(r * ops.n_pad, (r + 1) * ops.n_pad)
        _agree(ring[sl], ringp[sl], lw[r], lwp[r])
    y, l1 = klein_cuda.klein_draw(ops, B, uniforms=unif[:ops.n_pad])
    assert torch.equal(ring[:ops.n_pad], y) and torch.equal(lw[0], l1)


@pytest.mark.cuda
def test_b1_is_b2s_proposal_at_the_same_step(ops):
    """One stream: B1 at Philox step s draws B2's step-s proposal with the
    same conditional centres, bit for bit (the two debug instantiations
    write them), from any state of B2."""
    x, lw = klein_cuda.klein_draw(ops, B, seed=3, step=0)
    for s in (1, 7):
        c2, prop = klein_cuda.imhk_centres(ops, x.clone(), lw.clone(),
                                           seed=3, step=s)
        y, l1 = klein_cuda.klein_draw(ops, B, seed=3, step=s)
        c1, y1, lw1 = klein_cuda.klein_centres(ops, B, seed=3, step=s)
        assert torch.equal(y, prop) and torch.equal(y1, y)
        assert torch.equal(c1, c2) and torch.equal(lw1[0], l1)


@pytest.mark.cuda
def test_b1_b6_centres_within_the_gate_of_float64():
    """B1/B6's own centres (three bf16 passes on the tensor cores) within
    1e-3 sigma_i of float64 (hazard C2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(136)
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cuda")
    pre = klein_precompute(lat, 10.0, tail_budget=0.01)
    ops = klein_cuda.kernel_operands(pre)
    c, ring, _ = klein_cuda.klein_centres(ops, B, 2, seed=4)
    for r in range(2):
        sl = slice(r * ops.n_pad, r * ops.n_pad + N)
        x64 = ring[sl].double() + ops.shift[:N, None].double()
        c64 = pre.cs[:, None] - pre.U @ x64 + x64
        err = (c[sl].double() + ops.shift[:N, None].double() - c64).abs()
        assert float((err / pre.sigmas[:, None]).max()) < 1e-3


@pytest.mark.cuda
def test_b1_b6_raise_beyond_the_exact_range():
    """Hazard C8 for B1 and B6: a drawn |y| > 256 is not exact in their
    narrow bf16 tile, so the wrapper (or the entry point, reading its one
    guard) raises where the operands predict narrow draws and a draw passes
    256 (`far_centres`). Near 200 they run and report the range; a centre
    of 300 is predicted (fault C11) and runs on the WIDE instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             device="cuda")
    ops = KleinSampler(lat, 0.35).operands
    for centre, wide in ((200.0, False), (300.0, True)):
        ops.cs[0] = centre       # the recentred centre of row 0
        assert klein_cuda.wide_y(ops) == wide
        launch_record.reset()
        klein_cuda.klein_draw(ops, 256, seed=1)
        klein_cuda.klein_ring(ops, 256, 2, seed=1)
        for kernel in ("klein_draw", "klein_ring"):
            assert centre - 5 <= _rec(kernel, "max_abs_y") <= centre + 5
    ks = KleinSampler(far_lattice(), 0.02)
    far_centres(ks.operands)
    with pytest.raises(RuntimeError, match="klein_draw.*C8"):
        klein_cuda.klein_draw(ks.operands, 256, seed=1)
    with pytest.raises(RuntimeError, match="klein_ring.*C8"):
        klein_cuda.klein_ring(ks.operands, 256, 2, seed=1)
    with pytest.raises(RuntimeError, match="KleinSampler.*C8"):
        ks.sample(1, 256)


@pytest.mark.cuda
def test_b1_b6_fp32_route_above_the_tensor_core_reach():
    """Above n_pad 3,456 the draw tile does not fit a block: B1 and B6
    take klein.cu's FP32 sweep, chosen by n_pad before the launch, and
    match their plain versions (a basis of dimension 3,500 that is its own
    R, n_pad 3,584, a few chains)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, chains = 3500, 128
    rng = np.random.default_rng(35)
    basis = (np.triu(rng.uniform(-0.05, 0.05, (n, n)), 1)
             + np.diag(rng.uniform(1.0, 2.0, n)))
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(n), "R": basis,
                              "gs_norms": np.diag(basis)}, device="cuda")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 4.0,
                                                      tail_budget=0.01))
    assert ops.n_pad == 3584 and klein_cuda.klein_route(ops.n_pad) == "klein"
    launch_record.reset()
    unif = torch.rand(ops.n_pad, chains, device="cuda")
    y, lw = klein_cuda.klein_draw(ops, chains, uniforms=unif)
    yp, lwp = klein_cuda.klein_draw_plain(ops, chains, uniforms=unif)
    same = (y[:n] == yp[:n]).all(dim=0)
    assert 1 - same.float().mean().item() <= 0.05
    torch.testing.assert_close(lw[same], lwp[same], atol=1e-3, rtol=0)
    ring, lws = klein_cuda.klein_ring(ops, chains, 2, seed=5, step=1)
    ringp, lwsp = klein_cuda.klein_ring_plain(ops, chains, 2, seed=5,
                                              step=1)
    for r in range(2):
        sl = slice(r * ops.n_pad, r * ops.n_pad + n)
        same = (ring[sl] == ringp[sl]).all(dim=0)
        assert 1 - same.float().mean().item() <= 0.05
        torch.testing.assert_close(lws[r, same], lwsp[r, same], atol=1e-3,
                                   rtol=0)
    assert (_rec("klein_draw", "fp32_launches"),
            _rec("klein_ring", "fp32_launches")) == (1, 1)
    assert (_rec("klein_draw"),
            _rec("klein_ring")) == (0, 0)


@pytest.mark.cuda
def test_b5_matches_plain_at_ntru1024():
    """C10: B5 samples at dimension 2048 (NTRU-1024, the Peikert row at
    bench.py's BENCH_N = 1024; 16 chains a block): on the caller's normals
    coordinates differ from the plain version only by ties, each by one,
    and its own centres lie within 2e-3 r of float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = ntru_lattice(1024, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    s1 = float(np.linalg.norm(lat.basis.cpu().numpy(), 2))
    r = smoothing_parameter_zn(lat.n, 0.01)
    s = PeikertSampler(lat, 1.05 * r * s1, device="cuda")
    ops = s.operands
    assert ops.n_pad == 2048 and peikert_cuda.peikert_block_chains(2048) == 16
    z = torch.randn(2 * ops.n_pad, B, device="cuda")
    u = torch.rand(2 * ops.n_pad, B, device="cuda")
    ring = peikert_cuda.peikert_rounds(ops, B, 2, uniforms=u, normals=z)
    ringp = peikert_cuda.peikert_rounds_plain(ops, B, 2, uniforms=u,
                                              normals=z)
    diff = ring != ringp
    assert diff.float().mean().item() <= 1e-3
    assert bool(((ring - ringp).abs()[diff] == 1).all())
    c, _ = peikert_cuda.peikert_centres(ops, B, uniforms=u[:ops.n_pad],
                                        normals=z[:ops.n_pad])
    n = ops.n
    c64 = (s.pre.cprime.double()[:, None]
           - s.pre.L2.double() @ z[:n].double())
    assert float((c[:n].double() - c64).abs().max()) / r <= 2e-3
    X = s.sample(9, B, return_coeffs=True)
    assert X.shape == (B, n) and bool(torch.isfinite(X).all())


@pytest.mark.cuda
def test_b1_b2_b6_wide_match_plain_on_the_reduced_qary_basis():
    """Fault C11: on the LLL-reduced q-ary basis of the suite's n = 64 row
    (window 104) ~5% of the drawn coefficients pass 256. The wrappers
    predict it (`wide_y`) and take the WIDE instantiations, which carry y's
    wide parts: B1, B6 and B2 match their plain versions there, and nothing
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.experiments.benchmark import (
        reduced_qary_lattice,
    )
    lat = reduced_qary_lattice(64, 42, "cuda")
    pre = klein_precompute(lat, 1.5 * float(lat.gs_norms.max()),
                           tail_budget=1e-2)
    ops = klein_cuda.kernel_operands(pre)
    assert ops.window == 104 and klein_cuda.wide_y(ops)
    n, chains = ops.n, 2048
    launch_record.reset()
    y, lw = klein_cuda.klein_draw(ops, chains, seed=3)
    yp, lwp = klein_cuda.klein_draw_plain(ops, chains, seed=3)
    assert _rec("klein_draw", "max_abs_y") > 256
    same = (y[:n] == yp[:n]).all(dim=0)
    assert 1 - same.float().mean().item() <= MAX_CHAINS_DIFFERING
    torch.testing.assert_close(lw[same], lwp[same], atol=1e-3, rtol=0)
    ring, lws = klein_cuda.klein_ring(ops, chains, 2, seed=3)
    assert torch.equal(ring[:ops.n_pad], y) and torch.equal(lws[0], lw)
    x, l, a = y.clone(), lw.clone(), torch.zeros_like(lw)
    xp, lp, ap = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, x, l, a, 4, seed=5, step=1)
    klein_cuda.imhk_fused_plain(ops, xp, lp, ap, 4, seed=5, step=1)
    same = (x[:n] == xp[:n]).all(dim=0)
    assert 1 - same.float().mean().item() <= 4 * MAX_CHAINS_DIFFERING
    assert float(a.sum()) > 0 and abs(float(a.sum()) - float(ap.sum())) \
        <= 0.01 * float(ap.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("config,rule,wide", [("qary64_bkz20", "suite", 1),
                                              ("falcon512", "signing", 0)])
def test_sample_iid_takes_the_wide_route_where_draws_pass_256(
        config, rule, wide, tmp_path):
    """The benchmark's q-ary configuration (the BKZ-20 basis of the suite's
    n = 64 row at its width, window 88) predicts draws past 256: one
    `sample_iid` call sends B1 and B2 to their WIDE instantiations, one
    launch each, each in a `lgm.route.wide` span, and the largest |y| they
    drew reaches the record. On falcon512's basis nothing takes that
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import json

    from lattice_gaussian_mcmc_tpu_torch.utils.profiling import profile_trace
    from lgbench import harness
    from lgbench.reference import lattice as ref_lattice
    bench = harness.Bench()
    cfg = bench.config(config)
    basis = ref_lattice.basis_of(cfg, bench.dir)
    sigma = ref_lattice.sigma_of(cfg["sigma_rules"][rule], basis)
    s = IMHKSampler(lattice_from_basis(basis, device="cuda"), sigma,
                    tail_budget=0.01)
    assert klein_cuda.wide_y(s.operands) == bool(wide)
    launch_record.reset()
    with profile_trace(str(tmp_path)):
        X = s.sample_iid(5, 4096, n_steps=8)
        torch.cuda.synchronize()
    assert X.shape == (4096, basis.shape[0]) and bool(torch.isfinite(X).all())
    for kernel in ("klein_draw", "imhk_fused"):
        assert _rec(kernel) == 1
        assert _rec(kernel, "wide_launches") == wide
    top = max(_rec("klein_draw", "max_abs_y"), _rec("imhk_fused", "max_abs_y"))
    if wide:
        assert 256 < top < klein_cuda.WIDE_Y
    else:
        assert 0 < top <= 256
    with open(tmp_path / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert names.count("lgm.route.wide") == 2 * wide
    assert names.count("lgm.kernel.b1") == names.count("lgm.kernel.b2") == 1


def _ntru16_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return ntru_lattice(16, seed=42, cache_dir=os.path.join(REPO,
                                                            "bench_cache"),
                        device="cuda")


@pytest.mark.cuda
def test_blocked_route_launches_b1_and_b2(monkeypatch):
    """Repair R1: on CUDA tensors `klein_sample_batch_blocked` and
    `imhk_steps_batch_blocked` launch B1 and B2 (one launch a call, on
    operands built once for the precomputation), never the plain versions;
    the draws agree with B1's plain version in float64 on the CPU."""
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_blocked

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    lat = _ntru16_card()
    pre = klein_precompute(lat, 1.2 * float(lat.gs_norms.max()))
    monkeypatch.setattr(klein_cuda, "klein_draw_plain", plain)
    monkeypatch.setattr(klein_cuda, "imhk_fused_plain", plain)
    launch_record.reset()
    X, lw = klein_blocked.klein_sample_batch_blocked(pre, B, seed=3)
    X2, lw2, acc = klein_blocked.imhk_steps_batch_blocked(pre, X, lw, 6,
                                                          seed=3, step=1)
    assert _rec("klein_draw") == 1
    assert _rec("imhk_fused") == 1
    assert klein_blocked.blocked_operands(pre).U.dtype == torch.float32
    assert X.is_cuda and X2.shape == (B, lat.n) and acc.dtype == torch.int32
    assert 0 < int(acc.sum()) <= 6 * B
    monkeypatch.undo()
    Xp, lwp = klein_blocked.klein_sample_batch_blocked(pre.to("cpu"), B,
                                                       seed=3)
    same = (X.cpu() == Xp).all(dim=1)
    assert 1 - same.double().mean().item() <= MAX_CHAINS_DIFFERING
    torch.testing.assert_close(lw.cpu().double()[same], lwp[same],
                               atol=LW_ATOL, rtol=0)


@pytest.mark.cuda
def test_adapt_sigma_smk_launches_b4_on_disjoint_steps(monkeypatch):
    """`adapt_sigma_smk` starts on B1 and runs one B4 launch a window, the
    windows on consecutive, disjoint Philox step ranges, each history row
    with the window B4 took; two windows at the same width from the same
    state, at the first two windows' steps, give different acceptance
    counts chain by chain (one stream replayed would give equal ones)."""
    from lattice_gaussian_mcmc_tpu_torch.samplers import adaptation
    lat = _ntru16_card()
    sigma = float(lat.gs_norms.max())
    calls = []
    real = smk_cuda.smk_steps

    def record(ops, x, acc, n_steps, **kw):
        calls.append((kw["step"], n_steps))
        return real(ops, x, acc, n_steps, **kw)

    monkeypatch.setattr(smk_cuda, "smk_steps", record)
    launch_record.reset()
    st = adaptation.adapt_sigma_smk(lat, sigma, n_windows=6, window_steps=4,
                                    n_chains=4096, warmup_windows=3,
                                    max_window_steps=16, seed=7)
    assert _rec("klein_draw") == 1
    assert _rec("smk_steps") == 6
    assert calls == [(1, 4), (5, 4), (9, 4), (13, 16), (29, 16), (45, 16)]
    assert st.coeffs.shape == (4096, lat.n) and st.coeffs.is_cuda
    assert 0 < st.history[-1]["acceptance"] < 1
    pre = klein_precompute(lat, sigma)
    kops, x0, _ = adaptation._smk_start_card(pre, 4096, 7)
    assert [h["b4_window"] for h in st.history] == [
        smk_cuda.smk_operands(pre, h["sigma_prop"], klein_ops=kops).window
        for h in st.history]
    sops = smk_cuda.smk_operands(pre, st.sigma, klein_ops=kops)
    accs = []
    for step, k in calls[:2]:
        x, acc = x0.clone(), torch.zeros(4096, device="cuda")
        real(sops, x, acc, k, seed=7, step=step)
        accs.append(acc)
    assert (accs[0] != accs[1]).double().mean().item() > 0.2


@pytest.mark.cuda
def test_diagnose_convergence_runs_b1_b2_b3():
    lat = _ntru16_card()
    s = IMHKSampler(lat, 1.5 * float(lat.gs_norms.max()), burn_in=5,
                    device="cuda")
    launch_record.reset()
    d = s.diagnose_convergence(3, 300)
    assert _rec("klein_draw") == 2     # the start, the gap
    assert _rec("imhk_fused") == 1     # the burn-in
    assert _rec("imhk_trajectory") == 1
    assert 0 < d["acceptance_rate"] <= 1
    assert 0 < d["spectral_gap_estimate"] <= 1
    assert d["empirical_std"].shape == (lat.n,)


@pytest.mark.cuda
def test_sharded_paths_launch_b1_b2_and_b5(monkeypatch):
    """At world size 1 on the card `sharded_imhk_blocked` launches B1 and
    B2 once each and `sharded_peikert` B5 once, never the plain versions,
    and give the unsharded routes' bits; the same at a world-size-2
    rank's range, which is the unsharded batch's second half."""
    from lattice_gaussian_mcmc_tpu_torch.parallel import collectives, mesh
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_blocked

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    lat = _ntru16_card()
    pre = klein_precompute(lat, 1.2 * float(lat.gs_norms.max()))
    ops = peikert_cuda.peikert_operands(
        PeikertSampler(lat, 3.0 * float(np.linalg.norm(
            lat.basis.cpu().numpy(), 2))).pre)
    for name in ("klein_draw_plain", "imhk_fused_plain"):
        monkeypatch.setattr(klein_cuda, name, plain)
    monkeypatch.setattr(peikert_cuda, "peikert_rounds_plain", plain)
    launch_record.reset()
    m = mesh.make_mesh("cuda")
    X, lw, acc, rate = collectives.sharded_imhk_blocked(pre, B, 6, m, seed=3)
    Xp, _, var = collectives.sharded_peikert(ops, B, m, n_rounds=2, seed=4)
    assert _rec("klein_draw") == 1
    assert _rec("imhk_fused") == 1
    assert _rec("peikert_rounds") == 1
    assert 0.0 < rate <= 1.0 and X.is_cuda and Xp.shape == (2 * B, lat.n)
    assert bool(torch.isfinite(var).all()) and float(var.max()) > 0
    X0, lw0 = klein_blocked.klein_sample_batch_blocked(pre, B, seed=3)
    Xu, lwu, accu = klein_blocked.imhk_steps_batch_blocked(pre, X0, lw0, 6,
                                                           seed=3, step=1)
    assert torch.equal(X, Xu) and torch.equal(lw, lwu)
    assert torch.equal(acc, accu)
    half = mesh.ChainMesh(None, 1, 2, m.device)
    X1, _, _, _ = collectives.sharded_imhk_blocked(pre, B, 6, half, seed=3)
    assert torch.equal(X1, Xu[B // 2:])
    X1p, _, _ = collectives.sharded_peikert(ops, B, half, n_rounds=2, seed=4)
    assert torch.equal(X1p, Xp[B:])


def _chain_runs():
    """The five plain chain functions at small sizes on the card, each a
    (name, thunk, replays it takes)."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import decoding
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        annealed_gibbs_decode,
        gibbs_chain,
        imhk_chains,
        smk_chains,
    )
    lat2 = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                              device="cuda")
    pre2 = klein_precompute(lat2, 0.35)
    rng = np.random.default_rng(16)
    lat = decoding._channel_lattice(rng, 16, "cuda")
    basis = lat.basis.cpu().numpy()
    min_gs = float(lat.gs_norms.min())
    xs = rng.integers(-2, 3, size=(8, 16)).astype(np.float64)
    t = torch.as_tensor(xs @ basis.T + rng.normal(
        scale=0.45 * min_gs, size=(8, 16))).to("cuda")
    return [
        ("imhk_chains", lambda: imhk_chains(pre2, 8, 48, thin=2, burn_in=5,
                                            seed=3, chain_offset=2), 101),
        ("smk_chains", lambda: smk_chains(pre2, lat2.Q, lat2.R, 8, 16,
                                          burn_in=4, seed=3), 20),
        ("gibbs_chain", lambda: gibbs_chain(
            4, lat, t[0], 0.5 * min_gs, 12,
            x0=torch.zeros(6, 16, device="cuda")), 12),
        ("annealed_gibbs_decode", lambda: annealed_gibbs_decode(
            5, lat, t, 1.5 * 0.45 * min_gs, n_sweeps=10, n_chains=6), 10),
        ("mhk_decode_batch", lambda: decoding._mhk_decode_batch(
            6, lat, t, 0.45 * min_gs, n_steps=24,
            window=decoding.MHK_WINDOW), 24),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(5))
def test_captured_chain_equals_its_eager_run(index, monkeypatch):
    """On the card each plain chain function runs as replays of one
    captured graph a step or sweep (`utils/graphs.py`); with the capture
    swapped for the eager steps (what the CPU runs) it gives the same
    bits: coefficients, log-weights, accept counts, best points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.utils import graphs
    name, run, replays = _chain_runs()[index]
    graphs.reset_counts()
    got = run()
    torch.cuda.synchronize()
    assert (graphs.StepGraph.captures, graphs.StepGraph.replays) == (
        1, replays), name
    with monkeypatch.context() as m:
        m.setattr(graphs, "StepGraph", graphs.EagerSteps)
        want = run()
    assert graphs.StepGraph.replays == replays
    flat = [(a, b) for a, b in zip(got, want)]
    if name in ("imhk_chains", "smk_chains"):
        flat = flat[:-1] + [(getattr(got[-1], k), getattr(want[-1], k))
                            for k in ("coeffs", "log_w", "accepted")]
        assert got[-1].steps == want[-1].steps
    for a, b in flat:
        assert a.is_cuda and a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_launches_past_2_24_raise_before_any_kernel():
    """Hazard C15: on operands whose predicted |y| reaches 2^24 B1, B2, B3
    and B6 raise before launching; `tools/debug_sigma.py 1024` raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.tools import debug_sigma
    lat = lattice_from_basis(np.array([[1.0, 3e7], [0.0, 1.0]]),
                             device="cuda")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 1.0))
    x = torch.zeros(ops.n_pad, 64, device="cuda")
    lw, acc = torch.zeros(64, device="cuda"), torch.zeros(64, device="cuda")
    launch_record.reset()
    for what, call in (
            ("klein_draw", lambda: klein_cuda.klein_draw(ops, 64, seed=1)),
            ("klein_ring", lambda: klein_cuda.klein_ring(ops, 64, 2,
                                                         seed=1)),
            ("imhk_fused", lambda: klein_cuda.imhk_fused(ops, x, lw, acc, 2,
                                                         seed=1)),
            ("imhk_trajectory", lambda: klein_cuda.imhk_trajectory(
                ops, x, lw, acc, 2, seed=1))):
        with pytest.raises(ValueError, match=rf"{what}: .*2\^24.*C15"):
            call()
    assert (_rec("klein_draw"), _rec("klein_ring"),
            _rec("imhk_fused"),
            _rec("imhk_trajectory"),
            _rec("klein_draw", "fp32_launches")) == (0, 0, 0, 0, 0)
    assert not bool(x.any()) and not bool(acc.any())
    with pytest.raises(ValueError, match="C15"):
        debug_sigma.main(["1024"])


# FALCON-512 signing (samplers/sign.py): sigma, q, floor(beta^2) and the
# signing tail budget, whose window is 40 at n_pad 1024
SIGN = (165.7366, 12289, 34034726, 2.0 ** -64)


def _smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _sign_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    pre = klein_precompute(lat, SIGN[0], tail_budget=SIGN[3])
    ops = klein_cuda.kernel_operands(pre)
    assert (ops.n_pad, ops.window) == (1024, 40)
    return lat, ops


def _residual_centres(ops, chains, seed):
    """The signer's centres U (x_t - x0): a residual r uniform on
    [-1/2, 1/2) in every coordinate, one a chain, (n_pad, chains)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.rand(ops.n, chains, device="cuda", dtype=torch.float64,
                   generator=g) - 0.5
    cs = torch.zeros(ops.n_pad, chains, device="cuda")
    cs[:ops.n] = ops.U[:ops.n, :ops.n].double() @ r
    return cs


@pytest.mark.cuda
def test_b1_centred_matches_plain_at_the_signing_width():
    """Centred B1 at n_pad 1024, W 40 (compiled) on the signer's centres,
    a centre per chain, against its plain version on the caller's uniforms
    and on Philox, under chip_smoke.py's gates; its draws stay narrow."""
    smoke = _smoke()
    _, ops = _sign_operands()
    cs = _residual_centres(ops, ODD_CHAINS, 1)
    unif = torch.rand(ops.n_pad, ODD_CHAINS, device="cuda")
    launch_record.reset()
    for kw in ({"uniforms": unif}, {"seed": 2 ** 33 + 5, "step": 2}):
        y, lw = klein_cuda.klein_draw_centred(ops, cs, **kw)
        yp, lwp = klein_cuda.klein_draw_centred_plain(ops, cs, **kw)
        res = smoke.compare_draws(y, yp, lw, lwp, ops.n)
        assert smoke.draws_ok(res), res
    assert _rec("klein_draw_centred") == 2
    assert 0 < _rec("klein_draw_centred", "max_abs_y") <= 256
    # the chains' own centres: another chain's would draw elsewhere
    y2, _ = klein_cuda.klein_draw_centred(ops, cs.roll(1, dims=1),
                                          uniforms=unif)
    y, _ = klein_cuda.klein_draw_centred(ops, cs, uniforms=unif)
    assert bool((y2 != y).any(dim=0).float().mean() > 0.5)


@pytest.mark.cuda
def test_b1_centred_with_equal_centres_is_b1(ops):
    """All centres equal to the operands' cs: uncentred B1's draw bit for
    bit, at the signing width (W 40) and on the `ops` fixture's own
    centre, on both uniform sources (on Philox, centred B1 draws on the
    midpoint uniforms of B1's counters, handed to B1 as its uniforms)."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import sign_cuda
    _, sops = _sign_operands()
    ids = torch.arange(B, device="cuda")
    for o in (ops, sops):
        same = o.cs[:, None].expand(-1, B).contiguous()
        unif = torch.rand(o.n_pad, B, device="cuda")
        mid = sign_cuda.redraw_uniforms(11, ids, 3, o.n_pad)
        for kw, kwb in (({"uniforms": unif}, {"uniforms": unif}),
                        ({"seed": 11, "step": 3}, {"uniforms": mid})):
            y, lw = klein_cuda.klein_draw_centred(o, same, **kw)
            yb, lwb = klein_cuda.klein_draw(o, B, **kwb)
            assert torch.equal(y, yb) and torch.equal(lw, lwb)


@pytest.mark.cuda
def test_b1_centred_raises_where_draws_leave_the_narrow_range():
    """Hazard C8: centred B1 has no WIDE instantiation, so it raises before
    its launch where the draws are predicted past 256, and its guard
    raises where a draw passes 256 all the same (`far_centres`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ks = KleinSampler(far_lattice(), 0.02)
    ops = ks.operands
    ops.cs[1] = 300.0      # predicted past 256: B1 would take WIDE
    cs = ops.cs[:, None].expand(-1, 256).contiguous()
    launch_record.reset()
    with pytest.raises(ValueError, match="klein_draw_centred.*C8"):
        klein_cuda.klein_draw_centred(ops, cs, seed=1)
    assert _rec("klein_draw_centred") == 0
    far_centres(ops)
    cs = ops.cs[:, None].expand(-1, 256).contiguous()
    with pytest.raises(RuntimeError, match="klein_draw_centred.*C8"):
        klein_cuda.klein_draw_centred(ops, cs, seed=1)


@pytest.mark.cuda
def test_signer_kernels_match_their_plain_versions():
    """`csrc/sign.cu`: the hash-to-point and a redraw round's uniforms
    equal their plain versions bit for bit, past 32 bits of seed and at a
    ring degree that is no multiple of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import sign_cuda
    seed = 2 ** 37 + 11
    for n in (512, 13):
        c = sign_cuda.hash_to_point(seed, ODD_CHAINS, n, 12289, "cuda")
        assert torch.equal(c.cpu(), sign_cuda.hash_to_point_plain(
            seed, ODD_CHAINS, n, 12289, "cpu"))
    ids = torch.tensor([5, 65535, 17, 2 ** 31 + 3], device="cuda")
    u = sign_cuda.redraw_uniforms(seed, ids, 2, 1024)
    assert torch.equal(u.cpu(), sign_cuda.redraw_uniforms_plain(
        seed, ids.cpu(), 2, 1024))


@pytest.mark.cuda
def test_signer_on_the_card_matches_the_reference_and_verifies():
    """`FalconSigner` on NTRU-512 (hash-to-point kernel, centred B1 at W 40,
    float64 products, redraws): every signature verifies, and the share
    that differs from the benchmark's float64 reference is within its
    cell's limit."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from lattice_gaussian_mcmc_tpu_torch import FalconSigner
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import sign_cuda
    from lattice_gaussian_mcmc_tpu_torch.samplers import verify
    from lgbench import harness
    from lgbench.reference import sign as ref_sign
    lat, _ = _sign_operands()
    sigma, q, beta2, tail = SIGN
    signer = FalconSigner(lat, sigma, q, beta2, tail_budget=tail,
                          device="cuda")
    seed, m = 2 ** 35 + 3, 512
    c = signer.hash_to_point(seed, m)
    assert torch.equal(c.cpu(), sign_cuda.hash_to_point_plain(
        seed, m, 512, q, "cpu"))
    s = signer.sign(seed, c)
    with np.load(os.path.join(REPO, "bench_cache",
                              "ntru_512_12289_0_g.npz")) as key:
        h = key["h"]
    assert bool(verify(h, c, s, q, beta2).all())
    ref = ref_sign.Reference(lat.basis.cpu().numpy(), sigma,
                             {"q": q, "beta2": beta2, "tail_budget": tail},
                             "cuda")
    expected = ref.expected({"seed": torch.full((m,), seed),
                             "chain": torch.arange(m)})
    limit = harness.Bench().data("cells", "falcon512_sign.batch")
    assert harness.compare(s, expected) <= limit["limits"]["rows_differ"]


def _points_case(limbs, basis, x):
    """The points' kernel on x against the float64 DGEMM bit for bit, and
    its tile counts against the inputs'."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
    launch_record.reset()
    got = points_cuda.points(limbs, x)
    assert torch.equal(got, x.to(torch.float64) @ basis.T)
    assert _rec("points") == 1
    stats = points_cuda.limb_stats()
    assert stats == points_cuda.limb_counts(x)
    return stats


@pytest.mark.cuda
def test_points_at_the_peikert_and_signing_layouts():
    """Peikert's float32 ring view through `PeikertSampler.sample` and the
    signer's float64 x.T (a call's messages, a one- and a three-message
    redraw batch): the kernel equals the float64 DGEMM bit for bit, its
    tiles take two limbs, and the entry points launch it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch import FalconSigner
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
    s, _ = _peikert_row()
    basis = s.pre.basis
    x = s.sample(21, B, return_coeffs=True)
    assert x.stride(0) == 1 and x.dtype == torch.float32
    assert _points_case(s.limbs, basis, x)["limbs_2"] > 0
    launch_record.reset()
    assert torch.equal(s.sample(21, B), x.double() @ basis.T)
    assert _rec("points") == 1
    lat, _ = _sign_operands()
    sigma, q, beta2, tail = SIGN
    signer = FalconSigner(lat, sigma, q, beta2, tail_budget=tail,
                          device="cuda")
    c = signer.hash_to_point(5, ODD_CHAINS).to(torch.float64)
    x0, cs = signer.centres(c)
    y, _ = klein_cuda.klein_draw_centred(signer.operands, cs, seed=5)
    x = x0 + y[:x0.shape[0]]
    assert _points_case(signer._limbs, basis, x.T)["limbs_2"] > 0
    for m in (1, 3):
        _points_case(signer._limbs, basis, x[:, :m].contiguous().T)
    launch_record.reset()
    signer.sign(5, c)
    assert _rec("points") >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [512, 1024])
def test_points_at_the_imhk_layout(ring):
    """IMHK's row-major float32 coefficients at dimension 1024 and 2048,
    |x| <= 50 and a row count no multiple of 128: one limb a tile, equal
    to the float64 DGEMM bit for bit; `sample_iid` launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
    lat = ntru_lattice(ring, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cuda")
    limbs = points_cuda.points_operands(lat.basis)
    assert limbs.n_limbs == 1
    g = torch.Generator(device="cuda").manual_seed(ring)
    x = torch.randint(-50, 51, (ODD_CHAINS, lat.n), device="cuda",
                      generator=g).float()
    stats = _points_case(limbs, lat.basis, x)
    assert stats["limbs_1"] > 0 and stats["limbs_2"] == 0
    if ring == 512:
        s = IMHKSampler(lat, FALCON[ring][0], tail_budget=0.01)
        launch_record.reset()
        X = s.sample_iid(3, 256, n_steps=2, return_coeffs=True)
        assert torch.equal(s.sample_iid(3, 256, n_steps=2),
                           X.double() @ lat.basis.T)
        assert _rec("points") == 1


@pytest.mark.cuda
def test_points_reach_wide_bases_odd_shapes_and_nan():
    """A two-limb basis with coefficients of one to four limbs in one call
    (a pass of the products a limb), odd widths on element loads, a width
    past the limb planes' room (two passes over its columns), float64
    row-major and column-major: bit for bit against the float64 DGEMM; a
    value out of reach writes NaN over its 64 rows only; a call makes no
    host read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
    g = torch.Generator(device="cuda").manual_seed(9)
    # n 2100: the limb planes hold 2,048 columns, so x runs in two parts
    for n, top in ((200, 20000), (2, 90), (5, 30000), (2100, 90), (72, 127)):
        basis = torch.randint(-top, top + 1, (n, n), device="cuda",
                              generator=g).double()
        limbs = points_cuda.points_operands(basis)
        x = torch.randint(-100, 101, (300, n), device="cuda",
                          generator=g).double()
        x[3, 0], x[130, n - 1], x[260, n // 2] = -3000, 2 ** 20, -2 ** 30
        for xs in (x, x.float(), x.T.contiguous().T):
            _points_case(limbs, basis, xs)
    x[140, 1] = 0.5
    launch_record.reset()
    got = points_cuda.points(limbs, x)
    assert bool(got[128:192].isnan().all())
    assert not bool(got[:128].isnan().any() or got[192:].isnan().any())
    assert points_cuda.limb_stats() == points_cuda.limb_counts(x)
    assert points_cuda.limb_stats()["beyond"] == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        points_cuda.points(limbs, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
