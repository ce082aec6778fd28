"""The operands and arithmetic of B4's tensor-core kernel
(`csrc/smk_tc.cu`) on the CPU: an emulation of its split coupling (three
exact bf16 parts of U, hazard C2) held to float64 forward and reverse
centres on the SMK row's operands (NTRU-512, sigma 0.45 max ||b*_i||,
proposal 0.45 sigma, window 8), with U1 alone shown to fail the same gate;
the plain version of the kernel's debug instantiation against the plain
version's own debug outputs (which `tests/test_torch_smk.py` holds to the
Pallas kernel's debug mode). Hazard C8's guard is tested with the launch
record's (`tests/test_torch_launch_record.py`). The kernel itself runs
only on a card (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    ntru_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, smk_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import SMKSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 256
# chip_smoke.py's gate on B4's centres: max_i |c - c_f64| / sigma_prop,i
MAX_CENTRE_ERR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smk_row():
    """The SMK row's operands, a Klein draw of the target and one SMK
    proposal from it (the plain debug step)."""
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(REPO, "bench_cache"),
                       device="cpu")
    sigma = 0.45 * float(lat.gs_norms.max())
    s = SMKSampler(lat, sigma, proposal_sigma=0.45 * sigma,
                   tail_budget=0.01, device="cpu")
    ops = s.operands
    y, _ = klein_cuda.klein_draw(s.klein_operands, CHAINS, seed=31)
    c, cp, p = smk_cuda.smk_centres(ops, y.clone(), seed=13, step=1)
    return s, ops, y, c, cp, p


def _centres(U, y, p):
    """Forward and reverse centres of proposal p from state y, for a
    product U @ v given as a function: c = U y - (U p - p),
    c' = (U p) - (U y) + y."""
    ct, up = U(y), U(p)
    coup = up - p
    return ct - coup, ((p + coup) - ct) + y


def _errs(s, ops, y, p, c, cp):
    n = ops.n
    U64 = s._target_pre.U.double()
    c64, cp64 = _centres(lambda v: U64 @ v, y[:n].double(), p[:n].double())
    sp = 1.0 / ops.isgp[:n].double()[:, None]
    return (float(((c[:n].double() - c64).abs() / sp).max()),
            float(((cp[:n].double() - cp64).abs() / sp).max()))


def test_smk_row_operands(smk_row):
    s, ops, y, c, cp, p = smk_row
    assert (ops.n, ops.n_pad, ops.window) == (1024, 1024, 8)
    # B2's fragments of the target's U (shared with B1's operands), built
    # once per operand set
    assert ops.U is s.klein_operands.U
    frag = klein_cuda.tc_fragments(ops)
    assert klein_cuda.tc_fragments(ops) is frag
    assert frag.shape == (64, 64, 3, 32, 8)
    assert torch.equal(frag, klein_cuda.fragment_pack(
        klein_cuda.split_bf16(s.klein_operands.U)))
    assert smk_cuda.SMK_TC_MAX_N_PAD == klein_cuda.IMHK_TC_MAX_N_PAD
    # every state and proposal coefficient is exact in bf16 (hazard C8)
    assert float(y.abs().max()) <= klein_cuda.EXACT_Y
    assert float(p.abs().max()) <= klein_cuda.EXACT_Y


def test_plain_centres_within_gate(smk_row):
    s, ops, y, c, cp, p = smk_row
    err, err_rev = _errs(s, ops, y, p, c, cp)
    print(f"plain: forward {err:.3e}, reverse {err_rev:.3e}")
    assert err < MAX_CENTRE_ERR and err_rev < MAX_CENTRE_ERR


@pytest.mark.parametrize("passes", [3, 1])
def test_split_coupling_centres(smk_row, passes):
    """The kernel's products, U y at the launch start and U y' of the
    proposal, as three float32 products of the bf16 parts of U with the
    integer vectors, summed in float32: within the gate; U1 alone (one
    bf16 pass) far outside it."""
    s, ops, y, _, _, p = smk_row
    parts = klein_cuda.split_bf16(ops.U)[:passes]

    def U(v):
        return sum(q.float() @ v for q in parts)

    c, cp = _centres(U, y, p)
    err, err_rev = _errs(s, ops, y, p, c, cp)
    print(f"{passes} bf16 passes: forward {err:.3e}, reverse {err_rev:.3e}")
    if passes == 3:
        assert err < MAX_CENTRE_ERR and err_rev < MAX_CENTRE_ERR
    else:
        assert err > MAX_CENTRE_ERR and err_rev > MAX_CENTRE_ERR


def test_centres_plain_is_the_plain_debug_step():
    """The debug entry's plain version is one step of B4's plain version
    (state in place), and its outputs are that step's debug outputs: the
    forward centres, the reverse centres ctn - ct + y and the proposal,
    each coordinate of which lies in its window around its centre."""
    rng = np.random.default_rng(4)
    N = 20
    basis = (np.triu(rng.uniform(-0.1, 0.1, (N, N)), 1)
             + np.diag(rng.uniform(1.0, 2.0, N)))
    lat = lattice_from_basis(basis, device="cpu")
    s = SMKSampler(lat, 0.6, proposal_sigma=0.4, device="cpu")
    ops = s.operands
    y, _ = klein_cuda.klein_draw(s.klein_operands, 64, seed=1)
    x = y.clone()
    c, cp, p = smk_cuda.smk_centres(ops, x, seed=1, step=1)
    xd, ad = y.clone(), torch.zeros(64)
    _, _, _, dbg = smk_cuda.smk_steps_plain(ops, xd, ad, 1, seed=1, step=1,
                                            debug=True)
    assert torch.equal(x, xd)
    assert 0 < ad.sum() < 64
    for got, key in ((c, "c"), (cp, "cp"), (p, "p")):
        assert torch.equal(got, dbg[key]), key
    ct = ops.U @ y
    torch.testing.assert_close(cp[:N], (dbg["ctn"] - ct + y)[:N])
    half = ops.window // 2
    off = p[:N] - torch.round(c[:N])
    assert bool(((off >= -half) & (off < half)).all())
    # padded rows: no centre, no draw
    assert not bool(c[N:].any() or cp[N:].any() or p[N:].any())
    # the centres are ct - sum_{j>i} U_ij p_j of the proposal
    want = ct - (ops.U @ p - p)
    torch.testing.assert_close(c[:N], want[:N], atol=1e-4, rtol=0)
