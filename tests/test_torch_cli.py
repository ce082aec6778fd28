"""The port's CLI (`experiments/cli.py`, console script
`lattice-mcmc-torch`) against the JAX package's `lattice-mcmc` on the CPU.

Held exactly: the experiment tuple, the `--quick` and default configs each
experiment is dispatched with (field for field, but the JAX base config's
dtype, n_devices and save_samples, the JAX benchmark config's unread
n_samples and block, and the port's cache_dir, which the JAX drivers fix
to bench_cache/), and `_gates_passed` on the same payloads. The exits: 1 on
a gate failure, an exception and, without `--cpu`, on a machine with no
card; 0 for `mesh --cpu` (gloo CPU ranks)."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import cli as j_cli
from lattice_gaussian_mcmc_tpu_torch.experiments import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ONLY = {"dtype", "n_devices", "save_samples"}

# experiment -> (driver module, driver function) in each package
DRIVERS = {
    "convergence": ("convergence_study", "run_study"),
    "scaling": ("dimension_scaling", "run_scaling"),
    "crypto": ("cryptographic", "run_crypto_suite"),
    "sensitivity": ("parameter_sensitivity", "run_sensitivity"),
    "validation": ("klein_validation", "run_suite"),
    "benchmark": ("benchmark", "run_benchmarks"),
    "decoding": ("decoding", "run_decoding"),
    "adaptation": ("adaptation", "run_adaptation"),
}


def _captured_config(pkg, name, quick, monkeypatch, tmp_path):
    """The config (or keyword arguments) package `pkg`'s `_dispatch` hands
    experiment `name`'s driver, captured by a stand-in driver."""
    import importlib
    mod_name, fn = DRIVERS[name]
    mod = importlib.import_module(f"{pkg}.experiments.{mod_name}")
    seen = {}

    def fake(cfg=None, *args, **kwargs):
        seen["cfg"] = cfg
        seen["kwargs"] = kwargs
        return {"all_passed": True}

    monkeypatch.setattr(mod, fn, fake)
    if name == "crypto":
        monkeypatch.setattr(mod, "sigma_sensitivity", fake)
    if pkg == "lattice_gaussian_mcmc_tpu":
        j_cli._dispatch(name, str(tmp_path), quick)
    else:
        cli._dispatch(name, str(tmp_path), quick, "cpu")
    return seen


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_dispatch_configs_equal_jax(name, quick, monkeypatch, tmp_path):
    j = _captured_config("lattice_gaussian_mcmc_tpu", name, quick,
                         monkeypatch, tmp_path)
    t = _captured_config("lattice_gaussian_mcmc_tpu_torch", name, quick,
                         monkeypatch, tmp_path)
    if name == "validation":
        # run_suite(output_dir=..., quick=...) in both, the port's on a
        # device too
        assert t["kwargs"].pop("device") == "cpu"
        assert t["kwargs"] == j["kwargs"]
        return
    assert t["kwargs"] == {"device": "cpu"}
    jd, td = dataclasses.asdict(j["cfg"]), dataclasses.asdict(t["cfg"])
    j_only = JAX_ONLY | ({"n_samples", "block"} if name == "benchmark"
                         else set())
    t_only = {"cache_dir"} if name in ("crypto", "benchmark") else set()
    assert set(jd) - set(td) == j_only
    assert set(td) - set(jd) == t_only
    assert {k: jd[k] for k in td if k not in t_only} == \
        {k: td[k] for k in td if k not in t_only}


def test_experiments_equal_jax():
    assert cli.EXPERIMENTS == j_cli.EXPERIMENTS


@pytest.mark.parametrize("payload", [
    {"all_passed": True}, {"all_passed": False}, {"x": 1, "y": "z"},
    {"suite": {"all_passed": True}, "extra": {"all_passed": False}},
    {"rows": [1, 2, 3]}, {"rows": [{"passed": True}, {"passed": False}]},
    {"rows": [{"passed": True}, {"passed": True}]},
    [{"x": {"passed": False}}], {"passed": [1, 2]},
    {"a": [{"b": {"passed": True}}, {"c": {"all_passed": True}}]},
])
def test_gates_passed_equals_jax(payload):
    assert cli._gates_passed(payload) is j_cli._gates_passed(payload)


def test_gate_failure_and_exception_exit_nonzero(tmp_path, monkeypatch):
    def gates_fail(name, output_dir, quick, cpu):
        return {"experiment": name, "seconds": 0.0,
                "results": {"all_passed": False}}

    def boom(name, output_dir, quick, cpu):
        raise RuntimeError("boom")

    monkeypatch.setattr(cli, "run_experiment", gates_fail)
    assert cli.main(["--experiments", "scaling",
                     "--output-dir", str(tmp_path)]) == 1
    monkeypatch.setattr(cli, "run_experiment", boom)
    assert cli.main(["--experiments", "crypto",
                     "--output-dir", str(tmp_path)]) == 1
    summary = {s["experiment"]: s for s in json.loads(
        (tmp_path / "run_summary.json").read_text())}
    # the second run merged into the first run's summary
    assert summary["scaling"]["ok"] is False
    assert summary["scaling"]["gates_passed"] is False
    assert summary["crypto"]["ok"] is False
    assert summary["crypto"]["error"] == "boom"


def test_mesh_cpu_run_writes_mesh_scaling(tmp_path, monkeypatch):
    """`--experiments mesh --cpu`: exit 0 and mesh_scaling.json with its
    environment and all_passed, the CPU-rank curve cut to 1 and 2 ranks
    (the smoke runs 1, 2, 4 and 8)."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import mesh_scaling
    monkeypatch.setattr(mesh_scaling, "CPU_RANK_COUNTS", (1, 2))
    assert cli.main(["--experiments", "mesh", "--cpu",
                     "--output-dir", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "mesh" / "mesh_scaling.json").read_text())
    assert out["environment"] == "gloo_cpu_ranks"
    assert out["all_passed"] is True and out["card_rows"] == []
    assert [r["n_devices"] for r in out["pallas_rows"]] == [1, 2]
    assert all(r["device"] == "cpu" for r in out["rows"])
    assert [r["process_count"] for r in out["process_rows"]] == [1, 2]


def test_no_fallback_without_a_card(tmp_path):
    """Without --cpu every experiment asks for the card; with none, each
    fails with resolve_device's error and the run exits 1."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = cli.main(["--experiments", "scaling", "crypto", "sensitivity",
                   "adaptation", "--quick", "--output-dir", str(tmp_path)])
    assert rc == 1
    summary = json.loads((tmp_path / "run_summary.json").read_text())
    assert [s["experiment"] for s in summary] == [
        "adaptation", "crypto", "scaling", "sensitivity"]
    for s in summary:
        assert s["ok"] is False
        assert "no CUDA device is available" in s["error"]


def test_quick_cpu_run_of_two_experiments(tmp_path, monkeypatch):
    """`--quick --cpu` end to end for sensitivity and scaling: exit 0,
    both ok in run_summary.json, the run's log file written and closed.
    The scaling experiment's clock is this process's CPU time: its
    complexity exponent is fitted to times of the quick dimensions 32 and
    64, which on the wall clock the load of other processes can reverse."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import dimension_scaling
    monkeypatch.setattr(dimension_scaling, "time",
                        types.SimpleNamespace(perf_counter=time.process_time))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = cli.main(["--experiments", "sensitivity", "scaling", "--quick",
                       "--cpu", "--output-dir", str(tmp_path)])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    summary = json.loads((tmp_path / "run_summary.json").read_text())
    assert all(s["ok"] and s["gates_passed"] for s in summary)
    logs = os.listdir(tmp_path / "logs")
    assert len(logs) == 1
    from lattice_gaussian_mcmc_tpu_torch.utils.logging import get_logger
    assert not any(getattr(h, "baseFilename", "").startswith(
        str(tmp_path)) for h in get_logger().handlers)


def test_cli_and_adaptation_import_no_jax():
    """In a fresh interpreter where importing jax fails, the CLI and the
    adaptation modules import and the JAX package is never loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import lattice_gaussian_mcmc_tpu_torch.experiments.cli as cli
        import lattice_gaussian_mcmc_tpu_torch.samplers.adaptation
        import lattice_gaussian_mcmc_tpu_torch.samplers.adaptive
        import lattice_gaussian_mcmc_tpu_torch.samplers.utils
        import lattice_gaussian_mcmc_tpu_torch.experiments.adaptation
        import lattice_gaussian_mcmc_tpu_torch.experiments.cryptographic
        import lattice_gaussian_mcmc_tpu_torch.experiments.dimension_scaling
        import lattice_gaussian_mcmc_tpu_torch.experiments.parameter_sensitivity
        import lattice_gaussian_mcmc_tpu_torch.utils.logging
        assert cli.EXPERIMENTS
        bad = [m for m in sys.modules
               if m == "lattice_gaussian_mcmc_tpu"
               or m.startswith("lattice_gaussian_mcmc_tpu.")]
        assert not bad, bad
        print("isolated")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "isolated" in r.stdout
