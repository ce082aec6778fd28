"""Babai decoding (B7) on the tensor-core sweep (`csrc/klein_tc.cu`), on
the CPU: an emulation of the kernel's products, U in its three bf16 parts
times y in its bf16 parts (y1 = bf16(y), y2 = bf16(y - y1), y3 = the
rest), held to the float64 nearest plane and to
`babai_decode_batch_pallas` in interpret mode at n = 136, and on
`chip_smoke.py`'s reach basis, whose recentred coefficients pass 256 and
2^16, where y1 alone decodes wrong. The kernel itself runs only on a card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as jlat
from lattice_gaussian_mcmc_tpu.ops.kernels.klein_pallas import (
    babai_decode_batch_pallas,
)
from lattice_gaussian_mcmc_tpu.samplers import klein_precompute
from lattice_gaussian_mcmc_tpu_torch.lattices import (
    lattice_from_basis,
    lattice_from_numpy,
)
from lattice_gaussian_mcmc_tpu_torch.ops import linalg
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ROW_BLOCK = klein_cuda.ROW_BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_parts(x: torch.Tensor, k: int):
    """k parts of x (float64), each rounded to bf16 (nearest even) from
    what the parts before it left: x1 = bf16(x), x2 = bf16(x - x1), ..."""
    parts, r = [], x
    for _ in range(k):
        p = r.to(torch.bfloat16).double()
        parts.append(p)
        r = r - p
    return parts


def _emulate_b7(ops, ct: torch.Tensor, y_parts: int = 3) -> torch.Tensor:
    """B7's decode of the recentred centres ct (n_pad, B) as the kernel
    forms it: over 64-row blocks from the top, the coupling to the rows
    decoded is the float32 sum of the products U_p y_q of U's three bf16
    parts and y's first `y_parts` bf16 parts (each product exact); within
    a block each row's centre is ct_i - coupling - sum U_ij y_j rounded to
    float32, then rint (half to even)."""
    n_pad, B = ct.shape
    U = ops.U.double()
    U_parts = [p.double() for p in klein_cuda.split_bf16(ops.U)]
    y = torch.zeros(n_pad, B, dtype=torch.float64)
    for lo in range(n_pad - ROW_BLOCK, -1, -ROW_BLOCK):
        hi = lo + ROW_BLOCK
        acc = torch.zeros(ROW_BLOCK, B, dtype=torch.float32)
        for yq in _bf16_parts(y[hi:], y_parts):
            for Up in U_parts:
                acc = acc + (Up[lo:hi, hi:] @ yq).float()
        for i in range(hi - 1, lo - 1, -1):
            inner = U[i, i + 1:hi] @ y[i + 1:hi]
            c = (ct[i].double() - acc[i - lo].double() - inner).float()
            y[i] = torch.round(c).double()
    return y


def _decode(ops, targets, y_parts=3):
    ct, k = klein_cuda.babai_centres(ops, targets)
    return _emulate_b7(ops, ct, y_parts)[:ops.n].T + k, ct, k


def test_b7_split_matches_float64_and_pallas_n136():
    """n = 136 pads to 256 rows (four 64-row blocks); targets B x* + w,
    noise 0.1 against R_ii >= 1: the emulation, the float64 row scan, the
    port's plain version and the Pallas kernel (interpret mode, float32
    QR) all decode x*."""
    rng = np.random.default_rng(136)
    n = 136
    basis = (np.triu(rng.uniform(-0.5, 0.5, (n, n)), 1)
             + np.diag(rng.uniform(1.0, 2.0, n)))
    lat = lattice_from_basis(basis, device="cpu")
    xs = rng.integers(-2, 3, (128, n)).astype(np.float64)
    t = xs @ basis.T + rng.normal(scale=0.1, size=(128, n))
    t64 = torch.from_numpy(t)
    ops = klein_cuda.babai_operands(lat.Q, lat.R, torch.float32)
    assert klein_cuda.klein_route(ops.n_pad) == "klein_tc"
    X, ct, _ = _decode(ops, t64)
    Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t64)
    np.testing.assert_array_equal(X.numpy(), Xo.numpy())
    np.testing.assert_array_equal(X.numpy(), xs)
    y = klein_cuda.babai_decode_plain(ops, ct)
    assert torch.equal(_emulate_b7(ops, ct).float(), y)
    pre = klein_precompute(jlat(basis, dtype=jnp.float32), 8.0)
    with pltpu.force_tpu_interpret_mode():
        Xp = np.asarray(babai_decode_batch_pallas(
            pre, jnp.asarray(t.astype(np.float32)), tile=128,
            interpret=True))
    np.testing.assert_array_equal(X.numpy(), Xp)


def _reach(T=128, seed=77):
    rng = np.random.default_rng(seed)
    basis, xstar = chip_smoke.reach_basis(rng)
    n = basis.shape[0]
    lat = lattice_from_numpy({"basis": basis, "Q": np.eye(n), "R": basis,
                              "gs_norms": np.ones(n)}, device="cpu")
    xs = torch.from_numpy(xstar(T))
    t = xs @ lat.basis.T + torch.from_numpy(
        rng.choice([-0.25, 0.25], (T, n)))
    return lat, xs, t


def test_reach_basis_passes_each_part_boundary():
    """The smoke's reach basis: x* decodes exactly in float64, and the
    recentred coefficients y = x* - rint(ct) pass 256 and 2^16, with y's
    third bf16 part non-zero; every centre stays below 2^22, where
    quarters are exact in float32."""
    lat, xs, t = _reach()
    Xo = linalg.babai_nearest_plane(lat.Q, lat.R, t)
    assert torch.equal(Xo, xs)
    ops = klein_cuda.babai_operands(lat.Q, lat.R, torch.float32)
    ct, k = klein_cuda.babai_centres(ops, t)
    y = xs - k
    y1, y2, y3 = _bf16_parts(y, 3)
    assert bool((y1 + y2 + y3 == y).all())
    assert int((y.abs() <= 256).sum()) > 0
    assert int(((y.abs() > 256) & (y.abs() < 65536)).sum()) > 0
    assert int((y.abs() > 65536).sum()) > 0 and int((y3 != 0).sum()) > 0
    assert float(y.abs().max()) < 2 ** 21
    assert float(ct.abs().max()) < 2 ** 22
    # the float32 centres are the float64 ones: nothing was rounded
    c64 = t - k @ ops.U64.T
    assert torch.equal(ct[:lat.n].T.double(), c64)


def test_b7_split_reaches_beyond_256_with_y_parts():
    """Where |y| > 256 the three parts of y decode what float64 decodes,
    coefficient for coefficient (as the port's plain version and the
    Pallas kernel in interpret mode do); y1 alone, the bf16 tile without
    its wide parts, does not."""
    lat, xs, t = _reach()
    ops = klein_cuda.babai_operands(lat.Q, lat.R, torch.float32)
    X, ct, k = _decode(ops, t)
    assert torch.equal(X, xs)
    y = klein_cuda.babai_decode_plain(ops, ct)
    assert torch.equal(y[:lat.n].T.double() + k, xs)
    X1, _, _ = _decode(ops, t, y_parts=1)
    assert not torch.equal(X1, xs)
    pre = klein_precompute(jlat(lat.basis.numpy(), dtype=jnp.float32), 8.0)
    with pltpu.force_tpu_interpret_mode():
        Xp = np.asarray(babai_decode_batch_pallas(
            pre, jnp.asarray(t.numpy().astype(np.float32)), tile=128,
            interpret=True))
    np.testing.assert_array_equal(Xp, xs.numpy())
