"""The benchmark's q-ary configuration, `qary64_bkz20`, on the CPU: its
frozen basis is the port's crypto-suite basis (qary_lattice(64, 32,
q=3329, seed=42), LLL, BKZ-20 for 4 tours) bit for bit; the plain q-ary
reference (`lgbench/reference/qary.py`) accepts it as a basis of
Lambda_q(A) and refuses two mutants; the configuration plans the suite's
width and window and runs correct through the harness at dimension 64 with
the kernels' plain versions; the reader of `lgm.route.wide` spans
(`wide_launches.sample`) and the launch record's `wide_launches`."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import CryptoConfig
from lattice_gaussian_mcmc_tpu_torch.experiments.cryptographic import (
    build_lattice_suite,
    suite_sigma,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import launch_record
from lattice_gaussian_mcmc_tpu_torch.reduction import native_available
from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
from lgbench import harness
from lgbench.reference import imhk_sample_iid as ref_imhk
from lgbench.reference import lattice, qary
from lgbench.tests import tiny
from lgbench.trace import Trace

BENCH = harness.Bench()
CONFIG = "qary64_bkz20"
CELL = "qary64_bkz20.imhk_smooth"
N, K, Q, SEED = 64, 32, 3329, 42
WINDOW = 88         # klein_precompute's window at tail budget 0.01
SIGMA = 302.943     # 1.2 eta_0.01(Z^64) max ||b*_i||, to the digits shown


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def basis():
    cfg = BENCH.config(CONFIG)
    return lattice.basis_of(cfg, BENCH.dir)


def test_the_frozen_basis_is_the_suites_bkz20_basis(basis):
    if not native_available():
        pytest.skip("the suite reduces by BKZ only with the native library")
    suite = build_lattice_suite(CryptoConfig(qary_dims=(N,), ntru_n=()),
                                device="cpu")
    lat = suite[f"qary_{N}"]
    assert lat.name.endswith("-bkz20")
    assert np.array_equal(basis, lat.basis.numpy())
    raw = np.load(os.path.join(BENCH.dir, BENCH.config(CONFIG)["basis"]))
    assert raw["B"].dtype == np.int64 and int(np.abs(raw["B"]).max()) == 76


def _det_ok(B) -> bool:
    return abs(qary.exact_det(B)) == Q ** K


@pytest.mark.parametrize("mutant", [None, "leaves", "sublattice"])
def test_the_plain_reference_accepts_the_basis_and_refuses_mutants(
        basis, mutant):
    """Every column in Lambda_q(A) and |det B| = q^k: a basis of the q-ary
    lattice. A column plus e_0 leaves the lattice; 2 b_0 stays in it but
    spans a sublattice of index 2."""
    B = basis.astype(np.int64)
    A = qary.lwe_matrix(N, K, Q, SEED)
    assert A.shape == (K, N - K)
    if mutant == "leaves":
        B[0, 5] += 1
    elif mutant == "sublattice":
        B[:, 0] *= 2
    member = qary.in_lattice(B, A, Q)
    if mutant is None:
        assert member.all() and _det_ok(B)
    elif mutant == "leaves":
        assert member.tolist() == [j != 5 for j in range(N)]
    else:
        assert member.all() and not _det_ok(B)
        assert abs(qary.exact_det(B)) == 2 * Q ** K


def test_exact_det_is_the_determinant_of_small_integer_matrices():
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 6):
        for _ in range(20):
            M = rng.integers(-4, 5, (n, n))
            assert qary.exact_det(M) == round(np.linalg.det(M))
    assert qary.exact_det(np.array([[0, 1], [1, 0]])) == -1
    assert qary.exact_det(np.array([[1, 2], [2, 4]])) == 0


def test_the_configuration_plans_the_suites_width_and_window(basis):
    p = harness.plan(BENCH, CELL, "cpu")
    assert "key" not in p.config and "basis" in p.config
    assert p.basis.dtype == np.float64 and np.array_equal(p.basis, basis)
    assert p.config["sigma_rules"][p.mix["sigma_rule"]] == {
        "factor": 1.2, "eps": 0.01, "of": "gs_max"}
    lat = lattice_from_basis(basis, device="cpu")
    sigma = suite_sigma(lat)
    assert p.sigma == pytest.approx(sigma, rel=1e-12)
    assert round(p.sigma, 3) == SIGMA
    pre = klein_precompute(lat, p.sigma, tail_budget=p.mix["tail_budget"])
    ref = ref_imhk.Reference(p.basis, p.sigma, p.mix, "cpu")
    assert ref.window == pre.window == WINDOW
    assert (p.mix["chains"], p.mix["steps"]) == (524288, 64)


def _tiny_qary_root(tmp: str) -> harness.Bench:
    """A tiny root whose cell runs the configuration as it stands, at 64
    chains x 4 steps a call."""
    root = tiny.make_root(tmp)
    d = os.path.join(root, "lgbench")
    with open(os.path.join(d, "mixes", "imhk_suite.json")) as f:
        mix = json.load(f)
    tiny.write(os.path.join(d, "mixes", "tiny_suite.json"),
               dict(mix, chains=64, steps=4))
    tiny.write(os.path.join(d, "cells", "tiny_qary64.imhk.json"),
               {"rows_per_call": 16, "max_rows": 256, "min_rows": 16,
                "limits": {"rows_differ": 0.1}})
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny_qary64.imhk", "config": CONFIG,
                              "traffic": "tiny_suite", "chips": 1,
                              "why": "test"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "samples_per_s")["workloads"].append(
             "tiny_qary64.imhk")
    tiny.write(spec_path, spec)
    return harness.Bench(root)


def test_the_configuration_runs_correct_at_dimension_64(tmp_path):
    bench = _tiny_qary_root(str(tmp_path))
    r = harness.run(bench, "tiny_qary64.imhk", 2 ** 32 + 11, 0.3, False,
                    "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["checks"]["rows_checked"]["value"] >= 16
    assert set(r["metrics"]) == {"samples_per_s", "setup_s"}


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _ctx(spans):
    """A window of two calls holding the given host spans."""
    events = [_x("user_annotation", "lgbench.window", 0.0, 1000.0),
              _x("user_annotation", "lgbench.call", 10.0, 390.0),
              _x("user_annotation", "lgbench.call", 500.0, 400.0),
              _x("kernel", "void k(x)", 50.0, 50.0)]
    events += [_x("user_annotation", name, ts, 10.0) for name, ts in spans]
    return SimpleNamespace(trace=Trace({"traceEvents": events}), shapes={})


def _wide_launches(ctx):
    return BENCH.module("metrics", "wide_launches.sample").read(ctx)


def test_wide_launches_reads_wide_spans_a_call():
    entry = [("lgm.entry.sample_iid", 20.0), ("lgm.entry.sample_iid", 510.0)]
    wide = [("lgm.route.wide", t) for t in (30.0, 60.0, 520.0, 560.0,
                                            1500.0)]   # the last outside
    assert _wide_launches(_ctx(entry + wide)) == 2.0
    assert _wide_launches(_ctx(entry + wide[:3])) == 1.5
    # no entry span, no wide span, or no trace: nothing to read
    assert _wide_launches(_ctx(wide)) is None
    assert _wide_launches(_ctx(entry)) is None
    assert _wide_launches(SimpleNamespace(trace=None, shapes={})) is None
    decl = [m for m in BENCH.spec["per_layer"]
            if m["name"] == "wide_launches.sample"]
    assert len(decl) == 1 and decl[0]["workloads"] == [CELL]
    assert (decl[0]["layer"], decl[0]["source"]) == ("kernels",
                                                     "program_span")


def test_launch_record_counts_wide_launches():
    launch_record.reset()
    try:
        launch_record.count("klein_draw", wide=True)
        launch_record.count("imhk_fused", resident_chains=128, wide=True)
        launch_record.count("imhk_fused", resident_chains=256)
        rec = launch_record.read()
        assert all("wide_launches" in r for r in rec.values())
        assert set(rec) == set(launch_record.KERNELS)
        assert (rec["klein_draw"]["launches"],
                rec["klein_draw"]["wide_launches"]) == (1, 1)
        assert (rec["imhk_fused"]["launches"],
                rec["imhk_fused"]["wide_launches"]) == (2, 1)
        launch_record.reset()
        assert all(r["wide_launches"] == 0
                   for r in launch_record.read().values())
    finally:
        launch_record.reset()
