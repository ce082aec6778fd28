"""How a configuration names its lattice: the five cells plan the bases
and widths they planned from their NTRU keys, a frozen integer basis (the
port's q-ary 16 BKZ-20 basis) plans and runs correct, a bad file or
configuration is refused before any set-up, and the Gram-Schmidt width
rule is the port's crypto suite's."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from lattice_gaussian_mcmc_tpu_torch import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import CryptoConfig
from lattice_gaussian_mcmc_tpu_torch.experiments.cryptographic import (
    build_lattice_suite,
    suite_sigma,
)
from lgbench import harness
from lgbench.reference import lattice
from lgbench.tests import tiny

SPEC = harness.Bench().spec
QARY = "qary_16_8_3329_42.npz"
QARY_SHA256 = ("8178fa1b63f8070462c5e81112756d07"
               "a7c60c9be76859c4a8a4832c06e30250")
GS_MAX = {"factor": 1.2, "eps": 0.01, "of": "gs_max"}


def parent_sigma(rule: dict, B: np.ndarray) -> float:
    """The width rules as the harness read them before a configuration
    could name a frozen basis."""
    if "value" in rule:
        return float(rule["value"])
    return (float(rule["factor"])
            * lattice.smoothing_zn(B.shape[0], float(rule["eps"]))
            * float(np.linalg.norm(B, 2)))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_plans_its_keys_basis_and_width(cell):
    bench = harness.Bench()
    p = harness.plan(bench, cell, "cpu")
    assert "basis" not in p.config
    B = lattice.secret_basis(lattice.load_key(
        os.path.join(bench.dir, p.config["key"])))
    assert p.basis.dtype == np.float64 and np.array_equal(p.basis, B)
    rule = p.mix.get("sigma_rule")
    if rule is None:
        assert p.sigma is None
    else:
        assert p.sigma == parent_sigma(p.config["sigma_rules"][rule], B)


def qary_root(tmp: str, change=None) -> harness.Bench:
    """A tiny root with configuration "tiny_qary" on the frozen q-ary 16
    basis, an IMHK and a decode cell; `change(lgbench_dir)` gives fields
    of the configuration to override (None: remove)."""
    root = tiny.make_root(tmp)
    d = os.path.join(root, "lgbench")
    shutil.copy(os.path.join(tiny.HERE, "data", QARY),
                os.path.join(d, "data"))
    with open(os.path.join(d, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    for k in ("key", "key_sha256", "n", "q"):
        cfg.pop(k)
    cfg.update(name="tiny_qary", basis=f"data/{QARY}",
               basis_sha256=QARY_SHA256, dimension=16,
               sigma_rules={"suite": GS_MAX})
    for k, v in (change(d) if change else {}).items():
        if v is None:
            cfg.pop(k, None)
        else:
            cfg[k] = v
    tiny.write(os.path.join(d, "configs", "tiny_qary.json"), cfg)
    tiny.write(os.path.join(d, "mixes", "tiny_qary_imhk.json"),
               dict(tiny.MIXES["tiny_imhk"], sigma_rule="suite"))
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_qary", "source": "test",
                            "file": "lgbench/configs/tiny_qary.json",
                            "reduced": [], "why": "test"})
    for cell, mix, metric in (("tiny_qary.imhk", "tiny_qary_imhk",
                               "samples_per_s"),
                              ("tiny_qary.decode", "tiny_decode",
                               "decodes_per_s")):
        spec["workloads"].append({"name": cell, "config": "tiny_qary",
                                  "traffic": mix, "chips": 1, "why": "test"})
        next(m for m in spec["end_to_end"]
             if m["name"] == metric)["workloads"].append(cell)
        tiny.write(os.path.join(d, "cells", f"{cell}.json"),
                   {"rows_per_call": 16, "max_rows": 256, "min_rows": 16,
                    "limits": {"rows_differ": 0.1}})
    tiny.write(spec_path, spec)
    return harness.Bench(root)


def test_the_frozen_qary_basis_is_the_ports_bkz20_basis():
    path = os.path.join(tiny.HERE, "data", QARY)
    assert lattice.sha256(path) == QARY_SHA256
    suite = build_lattice_suite(CryptoConfig(qary_dims=(16,), ntru_n=()),
                                device="cpu")
    lat = suite["qary_16"]
    assert lat.name.endswith("-bkz20")
    assert np.array_equal(lattice.load_basis(path), lat.basis.numpy())


@pytest.mark.parametrize("cell,metric", [("tiny_qary.imhk", "samples_per_s"),
                                         ("tiny_qary.decode",
                                          "decodes_per_s")])
def test_a_configuration_on_a_frozen_basis_runs_correct(tmp_path, cell,
                                                        metric):
    bench = qary_root(str(tmp_path))
    B = lattice.load_basis(os.path.join(tiny.HERE, "data", QARY))
    p = harness.plan(bench, cell, "cpu")
    assert np.array_equal(p.basis, B)
    if p.mix.get("sigma_rule"):
        assert p.sigma == lattice.sigma_of(GS_MAX, B)
    r = harness.run(bench, cell, 2 ** 32 + 7, 0.3, False, "cpu",
                    time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["checks"]["rows_differ"]["value"] == 0.0
    assert set(r["metrics"]) == {metric, "setup_s"}


def save(path: str, B) -> str:
    np.savez(path, B=B)
    return lattice.sha256(path)


def bad_singular() -> np.ndarray:
    B = np.load(os.path.join(tiny.HERE, "data", QARY))["B"].copy()
    B[:, 3] = B[:, 1] + 2 * B[:, 2]
    return B


REFUSALS = {
    "sha256": (lambda d: {"basis_sha256": "0" * 64}, "sha256"),
    "both": (lambda d: {"key": "data/ntru_16_12289_0_g.npz",
                        "key_sha256": lattice.sha256(os.path.join(
                            d, "data", "ntru_16_12289_0_g.npz"))},
             "not exactly one"),
    "neither": (lambda d: {"basis": None, "basis_sha256": None},
                "not exactly one"),
    "dimension": (lambda d: {"dimension": 32}, "dimension 32"),
    "non_square": (lambda d: {"basis": "data/b.npz", "basis_sha256": save(
        os.path.join(d, "data", "b.npz"),
        np.ones((16, 15), dtype=np.int64))}, "not square"),
    "non_integer": (lambda d: {"basis": "data/b.npz", "basis_sha256": save(
        os.path.join(d, "data", "b.npz"),
        np.eye(16) * 2.5)}, "not int64"),
    "too_large": (lambda d: {"basis": "data/b.npz", "basis_sha256": save(
        os.path.join(d, "data", "b.npz"),
        np.eye(16, dtype=np.int64) * 2 ** 53)}, "2\\^53"),
    "singular": (lambda d: {"basis": "data/b.npz", "basis_sha256": save(
        os.path.join(d, "data", "b.npz"), bad_singular())}, "singular"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_a_bad_lattice_is_refused_before_set_up(tmp_path, monkeypatch,
                                                case):
    change, says = REFUSALS[case]
    bench = qary_root(str(tmp_path), change)

    def set_up(*a, **k):
        raise AssertionError("set-up reached")

    monkeypatch.setattr(harness.traffic, "make", set_up)
    for cell in ("tiny_qary.imhk", "tiny_qary.decode"):
        with pytest.raises(ValueError, match="'tiny_qary'") as e:
            harness.run(bench, cell, 3, 0.3, False, "cpu",
                        time.perf_counter())
        assert e.match(says)


def test_gs_max_rule_is_the_suites_width():
    B = lattice.load_basis(os.path.join(tiny.HERE, "data", QARY))
    want = suite_sigma(lattice_from_basis(B, device="cpu"))
    assert lattice.sigma_of(GS_MAX, B) == pytest.approx(want, rel=1e-12)
    # without "of" the rule stays Peikert's s1(B) bound
    rule = {"factor": 1.2, "eps": 0.01}
    assert lattice.sigma_of(rule, B) == parent_sigma(rule, B)
    with pytest.raises(ValueError, match="width rule"):
        lattice.sigma_of(dict(GS_MAX, of="gs_min"), B)
