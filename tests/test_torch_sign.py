"""FALCON-style signing (`samplers/sign.py` `FalconSigner`) on the CPU,
where the kernels' plain versions run: the signatures held row for row to
the benchmark's plain float64 reference (`lgbench/reference/sign.py`), each
one verified against the key's public h, redraws forced by a tight bound,
centred B1's plain version held to `klein_sample_batch(centers=)` and to
B1's plain version, the law in 2D against D_{L, sigma, t} enumerated at
two centres, and the benchmark's mix against its configuration. Keys come
from the port's keygen at ring degrees 16 and 32 (dimensions 32 and 64).
The kernels themselves run only on a card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import hashlib
import itertools
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch import FalconSigner, lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import (
    ntru_keygen,
    ntru_secret_basis,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, sign_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    klein_precompute,
    klein_sample_batch,
    verify,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    chain_ids,
    philox_midpoint,
    philox_uniform,
)
from lgbench import harness
from lgbench.reference import lattice as ref_lattice
from lgbench.reference import sign as ref_sign

Q = 12289
SEED = 2 ** 40 + 977         # past 32 bits: both key words matter
MESSAGES = 96
MAX_TVD = 0.02
LAW_DRAWS = 1 << 18
# the signing width over the largest Gram-Schmidt norm at the test keys: a
# Klein draw there is D_{L, sigma, t} to far below the tests' resolution
SIGMA_OVER_MAX_GS = 1.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(ring: int):
    key = ntru_keygen(ring, q=Q, seed=0)
    basis = ntru_secret_basis(key).astype(np.float64)
    _, R = ref_lattice.gso(basis)
    return key, basis, SIGMA_OVER_MAX_GS * float(np.max(np.diag(R)))


def _signer(basis, sigma, beta2, q=Q):
    lat = lattice_from_basis(basis, device="cpu")
    return FalconSigner(lat, sigma, q, beta2, device="cpu")


def _reference(basis, sigma, beta2):
    return ref_sign.Reference(basis, sigma, {
        "q": Q, "beta2": beta2, "tail_budget": 2.0 ** -64}, "cpu")


def _rows(seed, m):
    return {"seed": torch.full((m,), seed, dtype=torch.int64),
            "chain": torch.arange(m, dtype=torch.int64)}


@pytest.mark.parametrize("seed", [0, SEED])
def test_hash_to_point_is_the_references_and_the_same_in_any_batch(seed):
    _, basis, sigma = _key(16)
    c = sign_cuda.hash_to_point(seed, 40, 16, Q, "cpu")
    assert c.dtype == torch.int64 and c.shape == (40, 16)
    assert int(c.min()) >= 0 and int(c.max()) < Q
    ref = _reference(basis, sigma, 1)
    rows = _rows(seed, 40)
    assert torch.equal(ref.hashes(rows["seed"], rows["chain"]), c.double())
    assert torch.equal(sign_cuda.hash_to_point(seed, 7, 16, Q, "cpu"), c[:7])
    # ring degrees that are no multiple of 4 take the first words
    assert torch.equal(sign_cuda.hash_to_point(seed, 40, 13, Q, "cpu"),
                       c[:, :13])


@pytest.mark.parametrize("ring", [16, 32])
def test_signer_equals_the_reference_row_for_row(ring):
    _, basis, sigma = _key(ring)
    dim = basis.shape[0]
    beta2 = int(1.2 * dim * sigma ** 2)
    signer = _signer(basis, sigma, beta2)
    c = signer.hash_to_point(SEED, MESSAGES)
    s = signer.sign(SEED, c)
    assert s.dtype == torch.float64 and s.shape == (MESSAGES, dim)
    expected = _reference(basis, sigma, beta2).expected(_rows(SEED,
                                                              MESSAGES))
    assert torch.equal(s, expected)


@pytest.mark.parametrize("ring", [16, 32])
def test_every_signature_verifies_and_meets_the_bound(ring):
    key, basis, sigma = _key(ring)
    beta2 = int(1.2 * basis.shape[0] * sigma ** 2)
    signer = _signer(basis, sigma, beta2)
    c = signer.hash_to_point(SEED, MESSAGES)
    s = signer.sign(SEED, c)
    assert torch.equal(s, torch.round(s))
    assert bool(verify(key["h"], c, s, Q, beta2).all())
    assert int((s * s).sum(dim=1).max()) <= beta2
    # a changed signature, target or key no longer verifies
    bent = s.clone()
    bent[:, ring] += 1
    assert not bool(verify(key["h"], c, bent, Q, beta2).any())
    assert not bool(verify(key["h"], (c + 1) % Q, s, Q, beta2).any())
    assert not bool(verify(np.roll(key["h"], 1), c, s, Q, beta2).any())


def test_a_tight_bound_forces_redraws_that_match_the_reference():
    _, basis, sigma = _key(16)
    dim = basis.shape[0]
    # about half the first draws fail ||s||^2 <= beta2
    beta2 = int(dim * sigma ** 2)
    signer = _signer(basis, sigma, beta2)
    c = signer.hash_to_point(SEED, MESSAGES)
    s = signer.sign(SEED, c)
    assert signer.redraw_rounds >= 3
    assert int((s * s).sum(dim=1).max()) <= beta2
    ref = _reference(basis, sigma, beta2)
    assert torch.equal(s, ref.expected(_rows(SEED, MESSAGES)))
    # the messages that passed at once keep their first draw
    loose = _signer(basis, sigma, 10 ** 12).sign(SEED, c)
    first = (loose * loose).sum(dim=1) <= beta2
    assert 0 < int(first.sum()) < MESSAGES
    assert torch.equal(s[first], loose[first])
    assert not bool((s[~first] == loose[~first]).all(dim=1).any())


def _centred(ring, dtype):
    """NTRU operands at centre 0 and a batch of signing centres t = (0, c):
    (pre, ops, t (M, dim), x0 (dim, M), residual centres (n_pad, M))."""
    _, basis, sigma = _key(ring)
    lat = lattice_from_basis(basis, device="cpu")
    pre = klein_precompute(lat, sigma, tail_budget=2.0 ** -64)
    ops = klein_cuda.kernel_operands(pre, dtype=dtype)
    c = sign_cuda.hash_to_point(SEED, MESSAGES, ring, Q, "cpu").double()
    t = torch.cat([torch.zeros_like(c), c], dim=1)
    xt = torch.linalg.solve(lat.basis, t.T)
    x0 = torch.round(xt)
    cs = torch.zeros(ops.n_pad, MESSAGES, dtype=torch.float64)
    cs[:ops.n] = pre.U @ (xt - x0)
    return lat, pre, ops, t, x0, cs


def _philox_rows(ops, seed, step=0):
    return philox_uniform(seed, chain_ids(MESSAGES), step,
                          torch.arange(ops.n_pad))


def test_centred_plain_draws_equal_klein_sample_batch_centers():
    lat, pre, ops, t, x0, cs = _centred(16, torch.float64)
    # on klein_sample_batch's own uniforms (centred B1's Philox draws take
    # the midpoint uniforms)
    y, lw = klein_cuda.klein_draw_centred_plain(
        ops, cs, uniforms=_philox_rows(ops, SEED))
    # the same draws at the centres themselves: scaled (Q^T t) / diag(R)
    centers = (t @ lat.Q) / torch.diagonal(lat.R)
    X, lw_ref = klein_sample_batch(pre, MESSAGES, seed=SEED, centers=centers)
    assert torch.equal(x0 + y[:ops.n], X.T)
    # the window follows round(centre): the same log-normalisers
    torch.testing.assert_close(lw, lw_ref, atol=1e-9, rtol=0)
    # each draw's mean lies within 1/2 of 0: the coefficients stay small
    assert float(y.abs().max()) <= klein_cuda.predicted_y(ops) + 0.5


def test_centred_plain_draw_with_equal_centres_is_b1s_plain_version():
    _, _, ops, _, _, _ = _centred(16, torch.float32)
    same = ops.cs[:, None].expand(-1, MESSAGES).contiguous()
    unif = torch.rand(ops.n_pad, MESSAGES,
                      generator=torch.Generator().manual_seed(5))
    # on Philox, centred B1 takes the midpoint uniforms of B1's counters
    mid = philox_midpoint(SEED, chain_ids(MESSAGES), 3,
                          torch.arange(ops.n_pad))
    for kw, kwb in (({"seed": SEED, "step": 3}, {"uniforms": mid}),
                    ({"uniforms": unif}, {"uniforms": unif})):
        y, lw = klein_cuda.klein_draw_centred_plain(ops, same, **kw)
        yb, lwb = klein_cuda.klein_draw_plain(ops, MESSAGES, **kwb)
        assert torch.equal(y, yb) and torch.equal(lw, lwb)


def test_signing_uniforms_are_midpoints_that_exclude_0():
    # (k + 1/2) 2^-23 for the stream's k 2^-23, exactly, in float32
    ids = torch.tensor([0, 7, 2 ** 31 + 3])
    u = philox_uniform(SEED, ids, 2, torch.arange(300))
    mid = sign_cuda.redraw_uniforms_plain(SEED, ids, 2, 300)
    assert mid.dtype == torch.float32
    assert torch.equal(mid.double(), u.double() + 2.0 ** -24)
    k = mid.double() * 2.0 ** 23 - 0.5
    assert torch.equal(k, torch.round(k))
    assert float(mid.min()) >= 2.0 ** -24
    assert float(mid.max()) <= 1.0 - 2.0 ** -24
    # the stream's k = 0 takes the window's first point, its midpoint
    # the Gaussian's own draw (a row of width 1 around 0, window 40)
    isg = torch.ones(1, dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64)
    low = lambda v: klein_cuda._draw_row_plain(
        zero, isg, torch.full((1,), v, dtype=torch.float64), 40)[0]
    assert float(low(0.0)) == -20.0
    assert -7.0 < float(low(2.0 ** -24)) < -4.0


def test_centred_draws_on_philox_take_the_midpoint_uniforms():
    _, _, ops, _, _, cs = _centred(16, torch.float64)
    y, lw = klein_cuda.klein_draw_centred_plain(ops, cs, seed=SEED, step=2)
    mid = sign_cuda.redraw_uniforms_plain(SEED, chain_ids(MESSAGES), 2,
                                          ops.n_pad)
    ym, lwm = klein_cuda.klein_draw_centred_plain(ops, cs, uniforms=mid)
    assert torch.equal(y, ym) and torch.equal(lw, lwm)


def _pmf_2d(B, sigma, t, radius=16):
    """D_{L, sigma, t} on the coefficient box [-radius, radius]^2."""
    Binv = np.linalg.inv(B)
    mid = np.round(Binv @ t).astype(int)
    pts = {}
    for dx in itertools.product(range(-radius, radius + 1), repeat=2):
        x = mid + np.array(dx)
        v = B @ x - t
        pts[tuple(x)] = math.exp(-0.5 * float(v @ v) / sigma ** 2)
    z = sum(pts.values())
    return {k: v / z for k, v in pts.items()}


def _tvd(coeffs: np.ndarray, pmf: dict) -> float:
    keys, counts = np.unique(coeffs.astype(np.int64), axis=0,
                             return_counts=True)
    emp = {tuple(k): n / coeffs.shape[0] for k, n in zip(keys, counts)}
    return 0.5 * sum(abs(emp.get(k, 0.0) - pmf.get(k, 0.0))
                     for k in set(emp) | set(pmf))


@pytest.mark.parametrize("c", [1, 3])
def test_2d_signatures_follow_the_discrete_gaussian_at_their_centre(c):
    # a ring of degree 1: B = [[f, F], [g, G]], f G - g F = q = 5
    B = np.array([[2.0, -1.0], [1.0, 2.0]])
    q, sigma = 5, 4.0
    signer = FalconSigner(lattice_from_basis(B, device="cpu"), sigma, q,
                          10 ** 9, device="cpu")
    targets = torch.full((LAW_DRAWS, 1), c, dtype=torch.int64)
    s = signer.sign(SEED, targets)
    t = np.array([0.0, float(c)])
    x = np.rint(np.linalg.solve(B, (t[None, :] - s.numpy()).T).T)
    assert _tvd(x, _pmf_2d(B, sigma, t)) < MAX_TVD


def test_mix_agrees_with_the_configuration():
    bench = harness.Bench()
    cell = bench.cell("falcon512_sign.batch")
    config = bench.config(cell["config"])
    mix = bench.data("mixes", cell["traffic"])
    assert (mix["q"], mix["beta2"]) == (config["q"], config["beta2"])
    assert (config["q"], config["beta2"]) == (12289, 34034726)
    assert mix["tail_budget"] == 2.0 ** -64
    assert mix["entry"] == "sign" and mix["sigma_rule"] == "signing"
    assert config["sigma_rules"]["signing"]["value"] == 165.7366
    with open(os.path.join(harness.HERE, config["key"]), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == config["key_sha256"]
    basis = ref_lattice.secret_basis(ref_lattice.load_key(
        os.path.join(harness.HERE, config["key"])))
    _, R = ref_lattice.gso(basis)
    assert ref_lattice.window_budget(165.7366 / np.diag(R),
                                     mix["tail_budget"]) == 40
    with open(os.path.join(harness.HERE, "cells",
                           "falcon512_sign.batch.json")) as f:
        check = json.load(f)
    assert check["rows_per_call"] == 2 and check["max_rows"] == 1024


def _entry(ring, beta2):
    from lgbench.entries import sign as entry
    _, basis, sigma = _key(ring)
    plan = SimpleNamespace(basis=basis, sigma=sigma, device="cpu", mix={
        "chains": MESSAGES, "q": Q, "beta2": beta2,
        "tail_budget": 2.0 ** -64})
    return entry.Entry(plan)


def test_benchmark_entry_fails_a_call_with_a_row_above_the_bound():
    _, basis, sigma = _key(16)
    beta2 = int(basis.shape[0] * sigma ** 2)
    e = _entry(16, beta2)
    s = e.call({"seed": SEED})
    assert e.signer.redraw_rounds >= 3
    assert int((s * s).sum(dim=1).max()) <= beta2
    # a signer that does not redraw (its own bound loose) returns rows
    # above the bound, and the call raises
    e.signer.beta2 = 10 ** 12
    with pytest.raises(RuntimeError, match="above"):
        e.call({"seed": SEED})


@pytest.mark.parametrize("name", ["centred_block0", "sign_no_redraw"])
def test_the_signers_smoke_mutants_find_their_edit_sites(name):
    import smoke_mutants
    if name in smoke_mutants.MUTANTS:
        fname, old, _ = smoke_mutants.MUTANTS[name]
        path, edits = os.path.join(smoke_mutants.CSRC, fname), [old]
    else:
        path, pairs, phase, _ = smoke_mutants.ROUTE_MUTANTS[name]
        edits = [old for old, _ in pairs]
        assert phase == "signing"
    with open(os.path.join(smoke_mutants.REPO, path)) as f:
        src = f.read()
    assert all(src.count(old) == 1 for old in edits)
