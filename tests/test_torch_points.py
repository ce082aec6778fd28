"""Exact lattice points on the int8 tensor cores (`ops/kernels/
points_cuda.py`, `csrc/points.cu`) on the CPU: the kernel's limb arithmetic
in its plain PyTorch version held to the float64 product with torch.equal
(negative values, the limb edges, both layouts and both dtypes, tiles of
different limb counts in one call, one- and two-limb bases), the tile
counts that `limb_stats` reports, the layout the wrapper hands the kernel,
the basis route (a basis that is not integer-valued or reaches 2^15 keeps
the float64 product), and the limbs made once, at construction, by every
sampler and the signer. The kernel itself runs only on a card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch import FalconSigner, lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import (
    ntru_keygen,
    ntru_secret_basis,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    IMHKSampler,
    KleinSampler,
    PeikertSampler,
    SMKSampler,
    klein_points,
)

TR, TC = points_cuda.TILE_ROWS, points_cuda.TILE_COLS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _basis(n, top, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-top, top + 1, (n, n))).double()


def _f64(x, basis):
    return x.to(torch.float64) @ basis.T


def _layout(x, layout, dtype):
    """x (rows, n) as row-major or as the chain-minor view (rows
    contiguous) the kernel reads in place."""
    x = x.to(dtype)
    return x.contiguous() if layout == "rows" else x.T.contiguous().T


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["rows", "chain_minor"])
@pytest.mark.parametrize("top,basis_top,limbs", [
    (50, 94, 1),            # IMHK's coefficients, a FALCON-512 key
    (1700, 97, 1),          # Peikert's and the signer's
    (127, 128, 2),          # the limb edges, a two-limb basis
    (32767, 32767, 2),
    (2 ** 23, 120, 1),
])
def test_plain_limbs_equal_float64(dtype, layout, top, basis_top, limbs):
    n, rows = 72, 300     # ragged tiles in both directions
    basis = _basis(n, basis_top, seed=top % 97)
    ops = points_cuda.points_operands(basis)
    assert ops.n_limbs == limbs
    rng = np.random.default_rng(top)
    x = torch.from_numpy(rng.integers(-top, top + 1, (rows, n))).double()
    x[0, :4] = torch.tensor([-top, top, -1, 0], dtype=torch.float64)
    xs = _layout(x, layout, dtype)
    got = points_cuda.points_plain(ops, xs)
    assert got.dtype == torch.float64 and got.is_contiguous()
    assert torch.equal(got, _f64(x, basis))


@pytest.mark.parametrize("value,limbs", [
    (127, 1), (-128, 1), (128, 2), (-129, 2),
    (2 ** 15 - 1, 2), (-2 ** 15, 2), (2 ** 15, 3), (-2 ** 15 - 1, 3),
    (2 ** 23 - 1, 3), (-2 ** 23, 3), (2 ** 23, 4), (-2 ** 23 - 1, 4),
    (2 ** 31 - 1, 4), (-2 ** 31, 4),
])
def test_limb_edges(value, limbs):
    n = 40
    basis = _basis(n, 90)
    ops = points_cuda.points_operands(basis)
    x = torch.ones(5, n, dtype=torch.float64)
    x[3, 7] = value
    assert points_cuda.tile_limbs(x).tolist() == [[limbs, 1]]
    assert torch.equal(points_cuda.points_plain(ops, x), _f64(x, basis))


@pytest.mark.parametrize("basis_top", [90, 20000])
def test_tiles_of_every_limb_count_in_one_call(basis_top):
    n, rows = 96, 2 * TR
    basis = _basis(n, basis_top, seed=3)
    ops = points_cuda.points_operands(basis)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-100, 101, (rows, n))).double()
    x[5, TC + 1] = -3000                  # row tile 0, column tile 1
    x[TR + 9, 2] = 2 ** 20                # row tile 1, column tile 0
    x[TR + 50, 2 * TC + 3] = -2 ** 30     # row tile 1, column tile 2
    assert points_cuda.tile_limbs(x).tolist() == [[1, 2, 1], [3, 1, 4]]
    assert points_cuda.limb_counts(x) == {
        "limbs_1": 3, "limbs_2": 1, "limbs_3": 1, "limbs_4": 1, "beyond": 0}
    for dtype in (torch.float32, torch.float64):
        xs = x.to(dtype)
        assert torch.equal(points_cuda.points_plain(ops, xs),
                           _f64(xs, basis))


@pytest.mark.parametrize("bad", [0.5, float("nan"), float("inf"),
                                 2.0 ** 31, -2.0 ** 31 - 1])
def test_out_of_reach_rows_are_nan(bad):
    n, rows = 40, TR + 20
    basis = _basis(n, 90)
    ops = points_cuda.points_operands(basis)
    x = torch.ones(rows, n, dtype=torch.float64)
    x[TR + 3, 33] = bad
    got = points_cuda.points_plain(ops, x)
    assert torch.equal(got[:TR], _f64(x[:TR], basis))
    assert bool(got[TR:].isnan().all())
    assert points_cuda.limb_counts(x) == {
        "limbs_1": 3, "limbs_2": 0, "limbs_3": 0, "limbs_4": 0, "beyond": 1}


@pytest.mark.parametrize("make,col,vec", [
    # Peikert's ring view: (n_pad, B) float32, rows [:n], transposed
    (lambda: torch.zeros(1024, 4096)[:1000].T, 1, 1),
    # the signer's x.T: (2n, M) float64 transposed; a redraw round's
    (lambda: torch.zeros(64, 4096, dtype=torch.float64).T, 1, 1),
    (lambda: torch.zeros(64, 3, dtype=torch.float64).T, 1, 0),
    (lambda: torch.zeros(64, 6).T, 1, 0),
    # IMHK's row-major coefficients, float32 and float64: 16-byte loads
    (lambda: torch.zeros(4096, 1024), 0, 1),
    (lambda: torch.zeros(300, 72, dtype=torch.float64), 0, 1),
    # odd widths and offsets: element loads
    (lambda: torch.zeros(300, 2), 0, 0),
    (lambda: torch.zeros(7, 300)[:, :5], 0, 0),
    (lambda: torch.zeros(8, 9)[:, 1:], 0, 0),
    # one row, one column
    (lambda: torch.zeros(64, 1).T, 0, 1),
    (lambda: torch.zeros(1, 64).T, 0, 0),
])
def test_read_layout(make, col, vec):
    x = make()
    xs, sr, sk, got_col, got_vec = points_cuda.read_layout(x)
    assert (got_col, got_vec) == (col, vec)
    assert (sk if col == 0 else sr) == 1 or min(x.shape) == 1
    assert xs.data_ptr() == x.data_ptr()


def test_read_layout_copies_other_strides():
    x = torch.zeros(64, 96)[::2, ::3]
    xs, sr, sk, col, _ = points_cuda.read_layout(x)
    assert (sr, sk, col) == (32, 1, 0) and xs.is_contiguous()


@pytest.mark.parametrize("basis,limbs", [
    (lambda: _basis(48, 94), 1),
    (lambda: _basis(48, 127) - 1, 1),          # -128 is one signed byte
    (lambda: _basis(48, 32767), 2),
    (lambda: _basis(48, 94) + 0.5, None),      # not integer-valued
    (lambda: _basis(48, 94) * 1000, None),     # |B| >= 2^15
    (lambda: _basis(48, 94).float(), None),    # not float64
])
def test_basis_route(basis, limbs):
    b = basis()
    ops = points_cuda.points_operands(b)
    if limbs is None:
        assert ops is None
        # klein_points keeps the float64 product
        x = torch.ones(3, 48, dtype=b.dtype)
        assert torch.equal(klein_points(b, x, ops), x @ b.T)
        return
    assert ops.n_limbs == limbs and ops.n == 48
    bl = points_cuda.basis_limbs(ops)
    assert torch.equal(sum(bl[i] * 256 ** i for i in range(limbs)),
                       b.to(torch.int64))


def _lattice():
    rng = np.random.default_rng(11)
    basis = np.triu(rng.integers(-3, 4, (24, 24)), 1) + np.diag(
        rng.integers(4, 7, 24))
    return lattice_from_basis(basis.astype(np.float64), device="cpu")


SAMPLERS = {
    "klein": (lambda lat: KleinSampler(lat, 30.0, device="cpu"),
              lambda s: s.sample(5, 6)),
    "imhk_iid": (lambda lat: IMHKSampler(lat, 30.0, burn_in=2, device="cpu"),
                 lambda s: s.sample_iid(5, 6, n_steps=2)),
    "imhk": (lambda lat: IMHKSampler(lat, 30.0, burn_in=2, device="cpu"),
             lambda s: s.sample(5, 3, n_chains=2)),
    "smk": (lambda lat: SMKSampler(lat, 30.0, device="cpu"),
            lambda s: s.sample_iid(5, 6, n_steps=2)),
    "peikert": (lambda lat: PeikertSampler(lat, 400.0, device="cpu"),
                lambda s: s.sample(5, 6)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_split_the_basis_once(name, monkeypatch):
    make, call = SAMPLERS[name]
    lat = _lattice()
    sampler = make(lat)
    assert sampler.limbs is not None and sampler.limbs.n_limbs == 1

    def again(*_):
        raise AssertionError("the basis was split again in a call")

    monkeypatch.setattr(points_cuda, "points_operands", again)
    pts = call(sampler)
    # on the CPU the points are the float64 product of the coefficients
    coeffs = torch.linalg.solve(lat.basis, pts.T).T.round()
    assert torch.equal(pts, coeffs @ lat.basis.T)


def test_non_integer_basis_keeps_float64():
    lat = lattice_from_basis(np.diag(np.linspace(1.5, 2.5, 8)), device="cpu")
    sampler = KleinSampler(lat, 5.0, device="cpu")
    assert sampler.limbs is None
    coeffs = sampler.sample(2, 4, return_coeffs=True)
    assert torch.equal(sampler.sample(2, 4), coeffs.double() @ lat.basis.T)


def test_signer_splits_its_key_once(monkeypatch):
    basis = ntru_secret_basis(ntru_keygen(16, q=12289, seed=0))
    lat = lattice_from_basis(basis.astype(np.float64), device="cpu")
    sigma = 1.5 * float(lat.gs_norms.max())
    signer = FalconSigner(lat, sigma, 12289, int(4 * 32 * sigma ** 2),
                          device="cpu")
    assert signer._limbs is not None
    monkeypatch.setattr(points_cuda, "points_operands",
                        lambda *_: pytest.fail("split again"))
    s = signer.sign(3, signer.hash_to_point(3, 4))
    assert s.shape == (4, 32) and torch.equal(s, s.round())


def test_the_points_mutant_finds_its_edit_site():
    import os
    import smoke_mutants
    fname, old, _ = smoke_mutants.MUTANTS["points_no_high_limb"]
    with open(os.path.join(smoke_mutants.REPO, smoke_mutants.CSRC,
                           fname)) as f:
        assert f.read().count(old) == 1
    assert smoke_mutants.ONLY["points_no_high_limb"] == "points"


def test_the_kernel_stays_off_the_port_kernels_patterns():
    """Its device time counts in `offkernel_ms.*`, the layer it serves:
    no symbol pattern of B1-B8 matches the kernel's name."""
    import json
    import os
    import smoke_mutants
    root = smoke_mutants.REPO
    with open(os.path.join(root, "lgbench", "roofline",
                           "port_kernels.json")) as f:
        patterns = json.load(f)["patterns"]
    with open(os.path.join(root, smoke_mutants.CSRC, "points.cu")) as f:
        assert "points_s8_kernel<T, COL, NB>" in f.read()
    for name in ("points_s8_kernel<float, true, 1>",
                 "points_s8_kernel<double, false, 2>"):
        assert not any(p in name for p in patterns)
