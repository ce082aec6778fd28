"""The operands of B2/B3's tensor-core coupling (`csrc/imhk_tc.cu`) on the
CPU: the exact bf16 split of U (hazard C2), its packing in mma.sync
m16n8k16 A-fragment order, and an emulation of the split coupling held to
float64 centres on the flagship's operands (NTRU-512, sigma 165.7), with
U1 alone shown to fail the same gate. The kernel itself runs only on a
card (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import contextlib
import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    ntru_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    launch_record,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FALCON_SIGMA = 165.7
CHAINS = 256
# chip_smoke.py's gate on conditional centres: max_i |c - c_f64| / sigma_i
MAX_CENTRE_ERR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cpu")
    pre = klein_precompute(lat, FALCON_SIGMA, tail_budget=0.01)
    ops = klein_cuda.kernel_operands(pre)
    y, _ = klein_cuda.klein_draw(ops, CHAINS, seed=5)
    return pre, ops, y


def _centre_err(pre, ops, y, Uy):
    """max_i |c_i - c_f64,i| / sigma_i for the float32 centres
    c = cs - U y + y (U y given), as chip_smoke.py measures it."""
    c32 = ops.cs[:, None] - Uy + y
    x64 = (y + ops.shift[:, None]).double()
    c64 = pre.cs[:, None] - pre.U @ x64 + x64
    n = ops.n
    err = (c32[:n].double() + ops.shift[:n, None].double() - c64).abs()
    return float((err / pre.sigmas[:, None]).max())


def test_split_is_exact_on_ntru512(flagship):
    _, ops, _ = flagship
    U = ops.U.double()
    parts = klein_cuda.split_bf16(ops.U)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    for p in parts:
        # each part is a bf16 number: float32 -> bf16 -> float32 keeps it
        assert torch.equal(p.float().to(torch.bfloat16).float(), p.float())
    total = sum(p.double() for p in parts)
    assert bool(((total - U).abs() <= 2.0 ** -24 * U.abs()).all())
    # the parts shrink by ~2^-8 each
    assert float(parts[1].double().abs().max()) <= 2.0 ** -8 * float(
        U.abs().max())


def test_split_coupling_centres_within_gate(flagship):
    pre, ops, y = flagship
    parts = klein_cuda.split_bf16(ops.U)
    # three float32 products of the bf16 parts with the integer y, summed
    # in float32: the kernel's three passes
    Uy = sum(p.float() @ y for p in parts)
    err = _centre_err(pre, ops, y, Uy)
    print(f"split coupling: max |c - c_f64| / sigma_i = {err:.3e}")
    assert err < MAX_CENTRE_ERR
    # U1 alone (one bf16 pass) is far outside the gate (hazard C2)
    err1 = _centre_err(pre, ops, y, parts[0].float() @ y)
    print(f"U1 alone: max |c - c_f64| / sigma_i = {err1:.3e}")
    assert err1 > MAX_CENTRE_ERR


def _unpack(frag):
    """Inverse of fragment_pack for one part: (mt, mt, 32, 8) -> dense."""
    mt = frag.shape[0]
    rows, cols = klein_cuda._fragment_index("cpu")
    dense = torch.zeros(mt, mt, 16, 16, dtype=frag.dtype)
    dense[:, :, rows, cols] = frag
    return dense.permute(0, 2, 1, 3).reshape(16 * mt, 16 * mt)


def _mma_emulated(afrag, b):
    """D = A B for one m16n8k16 tile from lane-held A fragments (32, 8)
    and a dense B (16, 8), each lane forming its own four outputs the way
    mma.sync lays them out: rows g and g+8, columns 2t and 2t+1."""
    d = torch.zeros(16, 8, dtype=torch.float64)
    a = torch.zeros(16, 16, dtype=torch.float64)
    rows, cols = klein_cuda._fragment_index("cpu")
    for lane in range(32):
        a[rows[lane], cols[lane]] = afrag[lane].double()
    for lane in range(32):
        g, t = lane // 4, 2 * (lane % 4)
        for r in (g, g + 8):
            for c in (t, t + 1):
                d[r, c] = a[r] @ b[:, c].double()
    return d


@pytest.mark.parametrize("n", [2, 1024])
def test_operand_shapes_and_padding(n):
    if n == 2:
        lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                                 device="cpu")
        pre = klein_precompute(lat, 0.35)
    else:
        lat = ntru_lattice(512, q=12289, seed=0,
                           cache_dir=os.path.join(REPO, "bench_cache"),
                           device="cpu")
        pre = klein_precompute(lat, FALCON_SIGMA, tail_budget=0.01)
    ops = klein_cuda.kernel_operands(pre)
    n_pad = 128 if n == 2 else 1024
    mt = n_pad // 16
    assert ops.n == n and ops.n_pad == n_pad
    frag = klein_cuda.tc_fragments(ops)
    assert frag.shape == (mt, mt, 3, 32, 8)
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    # built once per operands, and only for B2/B3
    assert klein_cuda.tc_fragments(ops) is frag
    assert "_tc_fragments" not in vars(klein_cuda.kernel_operands(pre))
    dense = sum(_unpack(frag[:, :, p]).double() for p in range(3))
    assert torch.equal(dense, ops.U.double())
    # padded rows and columns are the identity's
    assert torch.equal(dense[n:, n:], torch.eye(n_pad - n,
                                                dtype=torch.float64))
    assert not bool(dense[:n, n:].any()) and not bool(dense[n:, :n].any())
    # one tile's emulated mma from the packed fragments is the dense product
    gen = torch.Generator().manual_seed(n)
    b = torch.randint(-40, 41, (16, 8), generator=gen).double()
    kt = min(1, mt - 1)
    got = sum(_mma_emulated(frag[0, kt, p], b) for p in range(3))
    want = ops.U.double()[:16, 16 * kt:16 * kt + 16] @ b
    assert torch.equal(got, want)


def test_centres_plain_is_a_b2_step():
    """The debug entry's plain version is one step of B2's plain version,
    and its centres are the backward substitution's own: each proposal
    coordinate lies in its window around the recorded centre."""
    rng = np.random.default_rng(3)
    N = 20
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cpu")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 0.6))
    y, lw = klein_cuda.klein_draw(ops, 64, seed=1)
    x, l = y.clone(), lw.clone()
    c, prop = klein_cuda.imhk_centres(ops, x, l, seed=1, step=1)
    xf, lf, af = y.clone(), lw.clone(), torch.zeros_like(lw)
    klein_cuda.imhk_fused(ops, xf, lf, af, 1, seed=1, step=1)
    assert torch.equal(x, xf) and torch.equal(l, lf)
    assert 0 < af.sum() < 64
    # accepted chains hold the proposal
    took = af == 1
    assert torch.equal(x[:, took], prop[:, took])
    half = ops.window // 2
    off = prop[:N] - torch.round(c[:N])
    assert bool(((off >= -half) & (off < half)).all())
    # the centres are cs - sum_{j>i} U_ij y_j of the proposal
    want = ops.cs[:, None] - ops.U @ prop + prop
    torch.testing.assert_close(c[:N], want[:N], atol=1e-4, rtol=0)


def test_wide_y_is_made_again_after_an_in_place_change():
    """Fault C11's prediction is kept on the operands and made again once
    U, cs or isg was changed in place. On [[1, 1000], [0, 1]] at sigma
    0.02, centres 0 predict narrow draws and a row-0 centre of 300 wide
    ones; centres (500, 0.5) keep row 0's mean at 0 and predict narrow,
    though the draws reach +-500 (the case the C8 guard catches)."""
    lat = lattice_from_basis(np.array([[1.0, 1000.0], [0.0, 1.0]]),
                             device="cpu")
    ops = klein_cuda.kernel_operands(klein_precompute(lat, 0.02))
    assert not klein_cuda.wide_y(ops)
    ops.cs[0] = 300.0
    assert klein_cuda.wide_y(ops)
    ops.cs[0], ops.cs[1] = 500.0, 0.5
    assert not klein_cuda.wide_y(ops)
    y, _ = klein_cuda.klein_draw_plain(ops, 64, seed=1)
    assert float(y[0].abs().max()) == 500.0


@pytest.mark.parametrize("n_pad,chains,blocks",
                         [(128, 1, 1), (1024, 997, 32), (2048, 64, 2)])
def test_proposal_scratch_holds_a_region_a_block(n_pad, chains, blocks):
    """B2/B3's proposals: n_pad x 64 bytes of bf16 for each block of 32
    chains, the last block part empty where the chains are not a
    multiple of 32."""
    s = klein_cuda.proposal_scratch(n_pad, chains, "cpu")
    assert s.shape == (blocks, n_pad, klein_cuda.TC_CHAINS)
    assert s.dtype == torch.bfloat16 and s.is_contiguous()
    assert s.numel() * s.element_size() == blocks * n_pad * 64


def test_residency_is_queried_once_a_key(monkeypatch):
    """Once per (device, n_pad, window, wide), each query on the key's
    card and not the current one."""
    calls, current = [], ["cuda:0"]

    @contextlib.contextmanager
    def on_device(device):
        prev, current[0] = current[0], device
        try:
            yield
        finally:
            current[0] = prev

    def resources(n_pad, window, wide=False):
        calls.append((current[0], n_pad, window, wide))
        return {"resident_chains": 192 if wide else 256}

    monkeypatch.setattr(klein_cuda.torch.cuda, "device", on_device)
    monkeypatch.setattr(klein_cuda, "imhk_tc_resources", resources)
    monkeypatch.setattr(klein_cuda, "_RESIDENCY", {})
    for _ in range(2):
        assert klein_cuda.imhk_tc_residency(1024, 16, False, "cuda:0") == 256
    assert klein_cuda.imhk_tc_residency(1024, 16, True, "cuda:0") == 192
    assert klein_cuda.imhk_tc_residency(2048, 24, False, "cuda:0") == 256
    assert klein_cuda.imhk_tc_residency(2048, 24, False, "cuda:1") == 256
    assert calls == [("cuda:0", 1024, 16, False), ("cuda:0", 1024, 16, True),
                     ("cuda:0", 2048, 24, False), ("cuda:1", 2048, 24, False)]
    assert current == ["cuda:0"]


def test_resources_count_the_chains_an_sm_holds(monkeypatch):
    class Lib:
        @staticmethod
        def imhk_tc_info(n_pad, window, wide, out):
            out[:] = [128, 128, 21120, 8, 64]
            return 0

    monkeypatch.setattr(klein_cuda, "load", lambda name: Lib())
    assert klein_cuda.imhk_tc_resources(1024, 16) == {
        "registers": 128, "local_bytes": 128, "shared_bytes": 21120,
        "blocks_per_sm": 8, "threads": 64, "resident_chains": 256}


def test_reset_clears_the_recorded_residency():
    for kernel in ("imhk_fused", "imhk_trajectory"):
        launch_record.count(kernel, resident_chains=256)
        assert launch_record.read()[kernel]["resident_chains"] == 256
    launch_record.reset()
    rec = launch_record.read()
    assert rec["imhk_fused"]["resident_chains"] == 0
    assert rec["imhk_trajectory"]["resident_chains"] == 0


def test_split_cuts_find_their_sites_once(tmp_path):
    """tools/imhk_split.py cuts the kernel by exact source strings."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build
    from lattice_gaussian_mcmc_tpu_torch.tools import imhk_split
    for name, edits in imhk_split.CUTS.items():
        _build.edited_sources(str(tmp_path / name), "imhk_tc.cu", edits)
