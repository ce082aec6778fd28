"""The harness: the frozen keys against the port's basis, no JAX in a
planned run, cells found by name, BENCHMARK.json's shape, the trace's
reduction and the command's refusals."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import ntru_secret_basis
from lgbench import harness
from lgbench.reference import lattice
from lgbench.tests import tiny
from lgbench.trace import Trace

SPEC = harness.Bench().spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("config", ["falcon512", "falcon1024"])
def test_frozen_key_builds_the_ports_basis(config):
    cfg = harness.Bench().config(config)
    path = os.path.join(harness.HERE, cfg["key"])
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cfg["key_sha256"]
    key = lattice.load_key(path)
    B = lattice.secret_basis(key)
    assert B.shape == (cfg["dimension"],) * 2
    assert np.array_equal(B, ntru_secret_basis(key).astype(np.float64))
    _, R = lattice.gso(B)
    # |det B| = q^n
    assert np.sum(np.log(np.diag(R))) == pytest.approx(
        cfg["n"] * np.log(cfg["q"]), rel=1e-9)


def test_planning_every_cell_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from lgbench import harness, control, run\n"
        "b = harness.Bench()\n"
        "for w in b.spec['workloads']:\n"
        "    for t in (False, True):\n"
        "        harness.plan(b, w['name'], 'cpu', t)\n"
        "print(harness.forbidden_modules())\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lattice_gaussian_mcmc_tpu_torch_x",
                        sys.modules[__name__])
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_root(str(tmp_path))
    d = os.path.join(root, "lgbench")
    before = {}
    for top, _, files in os.walk(d):
        for f in files:
            p = os.path.join(top, f)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    # a new configuration, mix, cell and per-layer metric: files only
    with open(os.path.join(d, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["sigma_rules"]["signing"] = {"value": 200.0}
    tiny.write(os.path.join(d, "configs", "tiny_wide.json"), cfg)
    mix = dict(tiny.MIXES["tiny_imhk"], chains=32, steps=4)
    tiny.write(os.path.join(d, "mixes", "tiny_short.json"), mix)
    tiny.write(os.path.join(d, "cells", "tiny_wide.short.json"),
               {"rows_per_call": 8, "max_rows": 64, "min_rows": 8,
                "limits": {"rows_differ": 0.1}})
    with open(os.path.join(d, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.latencies_s)\n")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_wide", "source": "test",
                            "file": "lgbench/configs/tiny_wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_wide.short",
                              "config": "tiny_wide", "traffic": "tiny_short",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "samples_per_s",
                              "workloads": ["tiny_wide.short"]})
    spec["end_to_end"][0]["workloads"].append("tiny_wide.short")
    tiny.write(spec_path, spec)
    bench = harness.Bench(root)
    r = harness.run(bench, "tiny_wide.short", 5, 0.3, True, "cpu",
                    time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["calls_seen"]["value"] == r["attempted"]
    r = harness.run(bench, "tiny_wide.short", 6, 0.3, False, "cpu",
                    time.perf_counter())
    assert set(r["metrics"]) == {"samples_per_s", "setup_s"}
    for p, content in before.items():
        with open(p, "rb") as fh:
            assert fh.read() == content, p


def test_benchmark_json_keeps_the_contract():
    assert SPEC["command"] == ["python3", "lgbench/run.py"]
    assert SPEC["paths"] == ["lgbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lgbench/") and NAME.match(c["name"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        for kind in ("mixes", "cells"):
            name = w["traffic"] if kind == "mixes" else w["name"]
            assert os.path.exists(os.path.join(harness.HERE, kind,
                                               f"{name}.json"))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].endswith("_roofline")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
    for cell in cells:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert [m for m in SPEC["per_layer"] if cell in m["workloads"]]


def test_trace_reduces_busy_idle_and_kernels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "lgbench.window",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "lgbench.call",
         "ts": 1.0, "dur": 60.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item",
         "ts": 40.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 20.0,
         "name": "void lgk::imhk_tc_kernel<16, false, false>(x)"},
        {"ph": "X", "cat": "kernel", "ts": 25.0, "dur": 10.0,
         "name": "void at::native::elementwise_kernel<128, 2>(x)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 70.0, "dur": 10.0,
         "name": "Memcpy DtoH"},
    ]
    t = Trace({"traceEvents": ev})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(35e-6)
    assert t.calls == 1
    assert t.kernel(r"imhk_tc_kernel<") == (pytest.approx(20e-6), 1)
    assert t.outside(["imhk_tc_kernel<"]) == pytest.approx(20e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void lgk::imhk")
    idle = dict(bd["idle_gaps"])
    assert idle["aten::item"] == pytest.approx(35e-6)     # 35 .. 70
    assert idle["lgbench.call"] == pytest.approx(10e-6)   # 0 .. 10
    assert idle["lgbench.window"] == pytest.approx(20e-6)  # 80 .. 100


def test_command_refuses_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["lgbench/run.py", "--workload", "falcon512.decode", "--seed",
            "4294967311", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    # a directory holding only BENCHMARK.json and lgbench/ cannot run
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "lgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
