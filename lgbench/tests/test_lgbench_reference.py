"""The plain reference held to exact enumeration in 2D, to Philox's
published answers and to an independent float64 nearest plane; its control
held to reading above each cell's limit at the cells' own dimension."""

import itertools
import math

import numpy as np
import pytest
import torch

from lgbench import control, harness
from lgbench.reference import (dgauss, imhk_sample_iid, lattice,
                               nearest_plane, peikert_sample, stream)

B2D = np.array([[1.0, 0.5], [0.0, 1.0]])    # columns are the basis vectors


def exact_pmf(B, sigma, radius=12):
    """D_{L, sigma} on the coefficient box [-radius, radius]^2."""
    pts = {}
    for x in itertools.product(range(-radius, radius + 1), repeat=2):
        v = B @ np.array(x, dtype=float)
        pts[x] = math.exp(-0.5 * float(v @ v) / sigma ** 2)
    z = sum(pts.values())
    return {k: v / z for k, v in pts.items()}


def tvd(coeffs: np.ndarray, pmf: dict) -> float:
    keys, counts = np.unique(coeffs.astype(np.int64), axis=0,
                             return_counts=True)
    emp = {tuple(k): c / coeffs.shape[0] for k, c in zip(keys, counts)}
    return 0.5 * sum(abs(emp.get(k, 0.0) - pmf.get(k, 0.0))
                     for k in set(emp) | set(pmf))


def rows(seed, m):
    return {"seed": torch.full((m,), seed, dtype=torch.int64),
            "chain": torch.arange(m, dtype=torch.int64)}


@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expect):
    t = [torch.tensor([v], dtype=torch.int64) for v in counter + key]
    assert tuple(int(w) for w in stream.philox(*t)) == expect


def test_stream_keys_and_units():
    s = torch.tensor([(7 << 32) + 5], dtype=torch.int64)
    assert [int(k) for k in stream.keys(s)] == [5, 7]
    w = torch.tensor([0, 0x7FFFFF, 0xFFFFFFFF], dtype=torch.int64)
    assert stream.unit(w).tolist() == [0.0, 1 - 2 ** -23, 1 - 2 ** -23]


def test_box_muller_normals_are_standard():
    s = torch.tensor([[12345]], dtype=torch.int64)
    z0, z1 = stream.normals(s, torch.arange(40000)[:, None],
                            torch.arange(8)[None, :], 0)
    z = torch.cat([z0.reshape(-1), z1.reshape(-1)])
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.01


def test_icdf_matches_the_window_law():
    u = (torch.arange(200000, dtype=torch.float64) + 0.5) / 200000
    c = torch.full_like(u, 0.3)
    z, logz = dgauss.icdf(u, c, 1.1, 16)
    support = torch.arange(-8, 8, dtype=torch.float64)
    w = torch.exp(-0.5 * ((support - 0.3) / 1.1) ** 2)
    p = (w / w.sum()).numpy()
    emp = np.array([(z == s).double().mean().item() for s in support])
    assert np.abs(emp - p).max() < 1e-4
    assert float(logz[0]) == pytest.approx(math.log(float(w.sum())))


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -10],
                     dtype=torch.float32)
    assert dgauss.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9]


@pytest.mark.parametrize("sigma", [0.35, 2.0])
def test_imhk_matches_exact_enumeration_in_2d(sigma):
    ref = imhk_sample_iid.Reference(B2D, sigma, {"steps": 16,
                                                 "tail_budget": 0.01}, "cpu")
    pts = ref.expected(rows(2 ** 33 + 1, 100000)).numpy()
    coeffs = np.linalg.solve(B2D, pts.T).T
    assert np.abs(coeffs - np.round(coeffs)).max() < 1e-9
    assert tvd(np.round(coeffs), exact_pmf(B2D, sigma)) < 0.02


def test_peikert_matches_exact_enumeration_in_2d():
    r = lattice.smoothing_zn(2, 0.01)
    sigma = 1.2 * r * float(np.linalg.norm(B2D, 2))
    ref = peikert_sample.Reference(B2D, sigma, {"eps": 0.01,
                                                "tail_budget": 0.01}, "cpu")
    pts = ref.expected(rows(99, 400000)).numpy()
    coeffs = np.round(np.linalg.solve(B2D, pts.T).T)
    assert tvd(coeffs, exact_pmf(B2D, sigma, radius=16)) < 0.025


def classic_nearest_plane(B, t):
    """Babai's nearest plane on Gram-Schmidt vectors by classic projection
    (Babai 1986), float64: an implementation independent of the QR one."""
    n = B.shape[1]
    bs = []
    for i in range(n):
        v = B[:, i].copy()
        for u in bs:
            v -= (B[:, i] @ u) / (u @ u) * u
        bs.append(v)
    x = np.zeros(n)
    r = t.copy()
    for i in range(n - 1, -1, -1):
        x[i] = np.round((r @ bs[i]) / (bs[i] @ bs[i]))
        r -= x[i] * B[:, i]
    return x


def test_nearest_plane_matches_classic_projection():
    rng = np.random.default_rng(3)
    B = rng.integers(-9, 10, size=(8, 8)).astype(float) + 12 * np.eye(8)
    T = rng.normal(0, 20, size=(200, 8))
    ref = nearest_plane.Reference(B, None, {}, "cpu")
    got = ref.expected({"target": torch.as_tensor(T)}).numpy()
    want = np.stack([classic_nearest_plane(B, t) for t in T])
    assert np.array_equal(got, want)


def test_nearest_plane_decodes_small_noise_to_the_point():
    key = lattice.load_key(f"{harness.HERE}/tests/data/"
                           "ntru_16_12289_0_g.npz")
    B = lattice.secret_basis(key)
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, size=(64, B.shape[0])).astype(float)
    T = x @ B.T + 0.05 * rng.normal(size=x.shape)
    ref = nearest_plane.Reference(B, None, {}, "cpu")
    assert np.array_equal(ref.expected({"target": torch.as_tensor(T)})
                          .numpy(), x)


@pytest.mark.parametrize("cell", ["falcon512.imhk_smooth", "falcon512.peikert",
                                  "falcon512.decode"])
def test_control_fails_the_cells_check(cell, monkeypatch):
    """The control at the cell's dimension (fewer rows than a run, on the
    CPU) reads above the cell's limit on two seeds."""
    bench = harness.Bench()
    p = harness.plan(bench, cell, "cpu")
    most = {"falcon512.imhk_smooth": 16}.get(cell, 128)
    monkeypatch.setitem(p.check, "max_rows", most)
    monkeypatch.setitem(p.check, "rows_per_call", min(most, 64))
    if "batch" in p.mix:        # smaller batches of targets, same rows
        monkeypatch.setitem(p.mix, "batch", 1024)
    monkeypatch.setattr(harness, "plan", lambda *a, **k: p)
    for seed in (11, 2 ** 32 + 12):
        r = control.reading(bench, cell, seed, "cpu")
        assert r["rows"] == most
        assert r["rows_differ"] > r["limit"]


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref_c = imhk_sample_iid.Reference(B2D, 0.35, {"steps": 8,
                                                  "tail_budget": 0.01}, "cpu")
    ref_g = imhk_sample_iid.Reference(B2D, 0.35, {"steps": 8,
                                                  "tail_budget": 0.01},
                                      "cuda")
    r = rows(5, 4096)
    assert torch.equal(ref_c.expected(r), ref_g.expected(r).cpu())
