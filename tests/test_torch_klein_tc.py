"""B1 and B6 on the tensor-core sweep (`csrc/klein_tc.cu`) and B5's block
shape (`csrc/peikert_tc.cu`), on the CPU: the exact three-part bf16 split
coupling held to float64 centres at the suite klein row's operands (B6:
NTRU-512 of seed 42, sigma 1.3 max ||b*_i||, window 24) and at the
hard-regime start's (B1: NTRU-512, sigma 0.45 max ||b*_i||, window 8), with
U1 alone shown to fail the same gate; the choice of B1/B6's kernel by
n_pad; B5's chains a block against a block's shared memory; and the debug
and stream identities of the plain versions. The kernels themselves run
only on a card (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

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
    peikert_cuda,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 128
# chip_smoke.py's gate on conditional centres: max_i |c - c_f64| / sigma_i
MAX_CENTRE_ERR = 1e-3
SMEM_PER_BLOCK = 232_448   # bytes of shared memory a block of sm_90 may take
# (ring degree, key seed, sigma / max ||b*_i||, window) of the two rows
ROWS = {"suite_klein_b6": (512, 42, 1.3, 24),
        "hard_regime_start_b1": (512, 0, 0.45, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _centre_err(pre, ops, y, Uy):
    """max_i |c_i - c_f64,i| / sigma_i for the float32 centres
    c = cs - U y + y (U y given), as chip_smoke.py measures it."""
    c32 = ops.cs[:, None] - Uy + y
    x64 = (y + ops.shift[:, None]).double()
    c64 = pre.cs[:, None] - pre.U @ x64 + x64
    n = ops.n
    err = (c32[:n].double() + ops.shift[:n, None].double() - c64).abs()
    return float((err / pre.sigmas[:, None]).max())


@pytest.mark.parametrize("row", sorted(ROWS))
def test_split_coupling_centres_within_gate(row):
    ring, seed, ratio, window = ROWS[row]
    lat = ntru_lattice(ring, q=12289, seed=seed,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cpu")
    pre = klein_precompute(lat, ratio * float(lat.gs_norms.max()),
                           tail_budget=0.01)
    ops = klein_cuda.kernel_operands(pre)
    assert (ops.n_pad, ops.window) == (1024, window)
    assert klein_cuda.klein_route(ops.n_pad) == "klein_tc"
    y, _ = klein_cuda.klein_draw(ops, CHAINS, seed=3)
    parts = klein_cuda.split_bf16(ops.U)
    # the parts are what tc_fragments packs for the kernel
    frag = klein_cuda.tc_fragments(ops)
    rows, cols = klein_cuda._fragment_index("cpu")
    for p, part in enumerate(parts):
        assert torch.equal(frag[0, 1, p], part[:16, 16:32][rows, cols])
    # three float32 products of the bf16 parts with the integer y, summed
    # in float32: the kernel's three passes
    err = _centre_err(pre, ops, y, sum(p.float() @ y for p in parts))
    print(f"{row}: split coupling max |c - c_f64| / sigma_i = {err:.3e}")
    assert err < MAX_CENTRE_ERR
    # U1 alone (one bf16 pass) is far outside the gate (hazard C2)
    err1 = _centre_err(pre, ops, y, parts[0].float() @ y)
    print(f"{row}: U1 alone max |c - c_f64| / sigma_i = {err1:.3e}")
    assert err1 > MAX_CENTRE_ERR


def test_b1_b6_route_by_n_pad():
    """The tensor-core sweep while its draw tile (64 n_pad + 9,344 bytes,
    imhk_tc_common.cuh `tc_smem_bytes`) fits a block, klein.cu's FP32 sweep
    above: chosen from n_pad alone, before any launch."""
    assert klein_cuda.KLEIN_TC_MAX_N_PAD == klein_cuda.IMHK_TC_MAX_N_PAD
    for n_pad in range(klein_cuda.BLOCK, 8192, klein_cuda.BLOCK):
        fits = 64 * n_pad + 9_344 <= SMEM_PER_BLOCK
        want = "klein_tc" if fits else "klein"
        assert klein_cuda.klein_route(n_pad) == want, n_pad
    assert klein_cuda.klein_route(3456) == "klein_tc"
    assert klein_cuda.klein_route(3584) == "klein"


@pytest.mark.parametrize("n_pad", [1024, 2048, 3456])
def test_b5_block_shape_fits_shared_memory(n_pad):
    """B5's chains a block: 32 while their normals tile fits a block's
    shared memory (n_pad <= 1,792), 16 above, up to every n_pad that B2-B4
    reach; NTRU-1024 (dimension 2048) takes 16."""
    chains = peikert_cuda.peikert_block_chains(n_pad)
    assert 4 * chains * n_pad <= SMEM_PER_BLOCK
    assert chains == (32 if n_pad <= 1792 else 16)
    assert n_pad <= peikert_cuda.PEIKERT_TC_MAX_N_PAD
    assert peikert_cuda.PEIKERT_TC_MAX_N_PAD >= klein_cuda.IMHK_TC_MAX_N_PAD
    assert peikert_cuda.PEIKERT_TC_MAX_N_PAD == 3584
    with pytest.raises(ValueError, match="3584"):
        peikert_cuda.peikert_block_chains(
            peikert_cuda.PEIKERT_TC_MAX_N_PAD + 64)


def _small_operands():
    rng = np.random.default_rng(3)
    N = 20
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cpu")
    return N, klein_cuda.kernel_operands(klein_precompute(lat, 0.6))


def test_centres_plain_is_the_ring():
    """The debug entry's plain version is B6's plain version, and its
    centres are the backward substitution's own: each draw lies in its
    window around the recorded centre."""
    N, ops = _small_operands()
    centres, ring, lws = klein_cuda.klein_centres(ops, 64, 2, seed=2, step=3)
    ringp, lwp = klein_cuda.klein_ring(ops, 64, 2, seed=2, step=3)
    assert torch.equal(ring, ringp) and torch.equal(lws, lwp)
    half = ops.window // 2
    for r in range(2):
        sl = slice(r * ops.n_pad, (r + 1) * ops.n_pad)
        c, y = centres[sl], ring[sl]
        off = y[:N] - torch.round(c[:N])
        assert bool(((off >= -half) & (off < half)).all())
        want = ops.cs[:, None] - ops.U @ y + y
        torch.testing.assert_close(c[:N], want[:N], atol=1e-4, rtol=0)


def test_b1_is_b2s_proposal_at_the_same_step():
    """One stream: B1's plain version at Philox step s draws the proposal
    that B2's plain version makes at step s, from any state."""
    _, ops = _small_operands()
    x, lw = klein_cuda.klein_draw(ops, 64, seed=1, step=0)
    for s in (1, 5):
        c2, prop = klein_cuda.imhk_centres(ops, x.clone(), lw.clone(),
                                           seed=1, step=s)
        y, _ = klein_cuda.klein_draw(ops, 64, seed=1, step=s)
        c1, _, _ = klein_cuda.klein_centres(ops, 64, seed=1, step=s)
        assert torch.equal(y, prop) and torch.equal(c1, c2)
