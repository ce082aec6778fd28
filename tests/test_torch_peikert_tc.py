"""The operands and arithmetic of B5's tensor-core kernel
(`csrc/peikert_tc.cu`) on the CPU: the TF32 split (hi + lo = x exactly),
L2's packing in mma.sync m16n8k8 A-fragment order, and an emulation of the
kernel's 3xTF32 product held to float64 centres on the Peikert row's
operands (NTRU-512, dimension 1024, sigma 1.05 r s1(B), hazard C9), with
the Pallas kernel's two-part bf16 split and a single TF32 pass shown to
fail the same gate. The kernel itself runs only on a card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    ntru_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.theta import smoothing_parameter_zn
from lattice_gaussian_mcmc_tpu_torch.samplers import PeikertSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 256
# chip_smoke.py's gate on B5's centres: max |c - c_f64| / r
MAX_CENTRE_ERR = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sampler(n):
    """The Peikert row's sampler at dimension 1024 (sigma 1.05 r s1(B) on
    the NTRU-512 basis); at 136 the CPU tests' B = I + upper-triangular
    noise at sigma 3 s1(B)."""
    if n == 1024:
        lat = ntru_lattice(512, q=12289, seed=0,
                           cache_dir=os.path.join(REPO, "bench_cache"),
                           device="cpu")
        s1 = float(np.linalg.norm(lat.basis.numpy(), 2))
        sigma = 1.05 * smoothing_parameter_zn(lat.n, 0.01) * s1
    else:
        rng = np.random.default_rng(5)
        basis = np.triu(rng.uniform(-0.5, 0.5, (n, n))) + np.eye(n)
        lat = lattice_from_basis(basis, device="cpu")
        sigma = 3.0 * float(np.linalg.norm(basis, 2))
    return PeikertSampler(lat, sigma, device="cpu")


@pytest.fixture(scope="module")
def peikert_row():
    s = _sampler(1024)
    ops = s.operands
    rng = np.random.default_rng(24)
    z = torch.from_numpy(rng.standard_normal((ops.n_pad, CHAINS))
                         .astype(np.float32))
    n = ops.n
    c64 = (s.pre.cprime.double()[:, None]
           - s.pre.L2.double() @ z[:n].double())
    return s, ops, z, c64


def _err(s, ops, C, c64):
    """max_i |c_i - c_f64,i| / r for the float32 centres c = c' - C."""
    c = ops.cp[:, None] - C
    return float((c[:ops.n].double() - c64).abs().max()) / float(s.pre.r)


def _tf32_pair(x):
    hi, lo = peikert_cuda.split_tf32(x)
    return hi, peikert_cuda.tf32_trunc(lo)


def test_row_operands(peikert_row):
    s, ops, _, _ = peikert_row
    assert (ops.n, ops.n_pad, ops.window) == (1024, 1024, 24)
    assert ops.n_pad <= peikert_cuda.PEIKERT_TC_MAX_N_PAD


def test_3xtf32_product_within_gate(peikert_row):
    """The kernel's product: hi.hi + (hi.lo + lo.hi) of the TF32 splits of
    L2 and z, each a float32 product of TF32 values (exact products)."""
    s, ops, z, c64 = peikert_row
    L2 = ops.L2T.T.contiguous()
    aH, aL = _tf32_pair(L2)
    bH, bL = _tf32_pair(z)
    err = _err(s, ops, aH @ bH + (aH @ bL + aL @ bH), c64)
    plain = _err(s, ops, L2 @ z, c64)
    print(f"3xTF32 {err:.3e} r, float32 {plain:.3e} r")
    assert err <= MAX_CENTRE_ERR
    assert plain <= MAX_CENTRE_ERR


@pytest.mark.parametrize("route", ["pallas_two_part_bf16", "one_tf32_pass"])
def test_cheaper_products_fail_the_gate(peikert_row, route):
    """The Pallas kernel's own split (bf16 hi.hi + hi.lo + lo.hi,
    peikert_pallas.py) and one TF32 pass put the centres beyond the gate
    (hazard C9)."""
    s, ops, z, c64 = peikert_row
    L2 = ops.L2T.T.contiguous()
    if route == "one_tf32_pass":
        C = peikert_cuda.tf32_trunc(L2) @ peikert_cuda.tf32_trunc(z)
    else:
        def bf16(x):
            hi = x.to(torch.bfloat16).float()
            return hi, (x - hi).to(torch.bfloat16).float()
        aH, aL = bf16(L2)
        bH, bL = bf16(z)
        C = aH @ bH + aH @ bL + aL @ bH
    err = _err(s, ops, C, c64)
    print(f"{route}: {err:.3e} r")
    assert err > MAX_CENTRE_ERR


def test_tf32_split_is_exact(peikert_row):
    """hi + lo = x in float32, hi has TF32's 10 mantissa bits and lies
    within a TF32 ulp of x, and the kernel's truncation of lo keeps it
    within a TF32 ulp of lo."""
    _, ops, z, _ = peikert_row
    for x in (ops.L2T, z):
        hi, lo = peikert_cuda.split_tf32(x)
        assert torch.equal(hi + lo, x)
        assert not bool((hi.view(torch.int32) & 0x1FFF).any())
        nz = hi != 0
        assert bool((lo[nz].abs() < 2.0 ** -10 * hi[nz].abs()).all())
        assert not bool(lo[~nz].any())
        lo_t = peikert_cuda.tf32_trunc(lo)
        assert bool(((lo_t - lo).abs() <= 2.0 ** -10 * lo.abs()).all())
    # truncation toward zero, as the kernel's mask
    t = torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -12, -(1.0 + 2.0 ** -11)])
    assert torch.equal(peikert_cuda.tf32_trunc(t), torch.tensor([1.0, -1.0]))


def _unpack(frag):
    """Inverse of fragment_pack_k8: (MT, KT, 32, 4) -> dense."""
    mt, kt = frag.shape[:2]
    rows, cols = peikert_cuda._fragment_index_k8("cpu")
    dense = torch.zeros(mt, kt, 16, 8, dtype=frag.dtype)
    dense[:, :, rows, cols] = frag
    return dense.permute(0, 2, 1, 3).reshape(16 * mt, 8 * kt)


def _mma_emulated(afrag, b):
    """D = A B for one m16n8k8 tile from lane-held A fragments (32, 4) and
    a dense B (8, 8), each lane forming its four outputs the way mma.sync
    lays them out: rows g and g+8, columns 2t and 2t+1; B's registers
    b0 = B[t, g], b1 = B[t + 4, g]."""
    rows, cols = peikert_cuda._fragment_index_k8("cpu")
    a = torch.zeros(16, 8, dtype=torch.float64)
    bt = torch.zeros(8, 8, dtype=torch.float64)
    for lane in range(32):
        a[rows[lane], cols[lane]] = afrag[lane].double()
        g, t = lane // 4, lane % 4
        bt[t, g], bt[t + 4, g] = b[t, g], b[t + 4, g]
    d = torch.zeros(16, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in (g, g + 8):
            for c in (2 * t, 2 * t + 1):
                d[r, c] = a[r] @ bt[:, c]
    return d


@pytest.mark.parametrize("n", [136, 1024])
def test_operand_shapes_and_padding(n):
    s = _sampler(n)
    ops = s.operands
    n_pad = 192 if n == 136 else 1024
    assert ops.n == n and ops.n_pad == n_pad
    frag = peikert_cuda.peikert_fragments(ops)
    assert frag.shape == (n_pad // 16, n_pad // 8, 32, 4)
    assert frag.dtype == torch.float32 and frag.is_contiguous()
    assert peikert_cuda.peikert_fragments(ops) is frag
    L2 = _unpack(frag)
    assert torch.equal(L2, ops.L2T.T)
    # lower triangular, the padding zero: the kernel's K loop stops at each
    # tile's diagonal and the padded rows draw around c' = 0
    assert not bool(torch.triu(L2, 1).any())
    assert not bool(L2[n:].any() or L2[:, n:].any() or ops.cp[n:].any())
    # one tile's emulated mma from the packed fragments is the dense product
    gen = torch.Generator().manual_seed(n)
    b = torch.randn(8, 8, generator=gen, dtype=torch.float64)
    mt, kt = n_pad // 16 - 1, n_pad // 8 - 2
    got = _mma_emulated(frag[mt, kt], b)
    want = L2.double()[16 * mt:16 * mt + 16, 8 * kt:8 * kt + 8] @ b
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_centres_plain_is_round_zero():
    """The debug entry's plain version: round 0 of the plain ring and its
    centres c' - L2 z."""
    s = _sampler(136)
    ops = s.operands
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.standard_normal((ops.n_pad, 64))
                         .astype(np.float32))
    u = torch.from_numpy(rng.random((ops.n_pad, 64)).astype(np.float32))
    c, ring = peikert_cuda.peikert_centres(ops, 64, uniforms=u, normals=z)
    assert torch.equal(ring, peikert_cuda.peikert_rounds_plain(
        ops, 64, 1, uniforms=u, normals=z))
    torch.testing.assert_close(c, ops.cp[:, None] - ops.L2T.T @ z)
    half = ops.window // 2
    off = ring - torch.round(c)
    assert bool(((off >= -half) & (off < half)).all())
