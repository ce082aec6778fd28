"""The port's check scripts and examples on the CPU: `tools/debug_sigma.py`,
`tools/check_lattice.py` and `tools/bkz_quality.py` (the ports of
`scripts/debug_sigma.py`, `check_lattice.py` and `bkz_quality.py`, with
their gates and exit codes), `examples/quickstart.py` and
`examples/ntru_falcon.py` at their smallest sizes, and the asymptotic
analysis's repeated timings (hazard C13)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.examples import ntru_falcon, quickstart
from lattice_gaussian_mcmc_tpu_torch.experiments import dimension_scaling
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import ScalingConfig
from lattice_gaussian_mcmc_tpu_torch.lattices.qary import _root_hermite
from lattice_gaussian_mcmc_tpu_torch.tools import (
    bkz_quality,
    check_lattice,
    debug_sigma,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import device_from_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_device_from_argv():
    assert device_from_argv(["zn", "--cpu", "8"]) == (["zn", "8"], "cpu")
    assert device_from_argv(["--device", "cuda:0", "3"]) == (["3"], "cuda:0")
    assert device_from_argv(["--device=cpu"]) == ([], "cpu")
    assert device_from_argv(["qary"]) == (["qary"], None)


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["16", "--cpu"]])
def test_debug_sigma_passes(argv, capsys):
    """E||x|| within 2% of sigma_d sqrt(n) on Z^n and 5% on the random
    triangular basis, on B1's plain version."""
    assert debug_sigma.main(argv) == 0
    out = capsys.readouterr().out
    assert "sanity: PASS" in out and out.count("E||x||") == 2


def test_discrete_gaussian_variance():
    """Below sigma 1 the discrete variance is under sigma^2; far above it,
    equal."""
    assert debug_sigma.discrete_gaussian_variance(0.4) < 0.16
    assert debug_sigma.discrete_gaussian_variance(6.0) == pytest.approx(
        36.0, rel=1e-12)


@pytest.mark.parametrize("argv, rc", [
    (["zn", "32"], 0),
    (["ntru", "16"], 0),
    (["qary", "16", "5"], 0),
    # the unreduced q-ary basis at the default 1.3 max||b*||: its window
    # clamps at 1024, which the JAX script fails the same way
    (["qary", "16"], 1),
])
def test_check_lattice(argv, rc, capsys):
    assert check_lattice.main([*argv, "--device", "cpu"]) == rc
    out = capsys.readouterr().out
    assert ("check: PASS" if rc == 0 else "check: FAIL") in out
    if argv[0] == "ntru":
        assert "NTRU det == q^n OK" in out
    if argv[0] == "qary":
        assert "q*Z^n subset OK" in out


def test_bkz_quality_at_reduced_size(tmp_path):
    """BKZ-20 and 30 at q-ary n = 64: within 2% of the GSA model's root-
    Hermite factor, non-increasing in beta; the JSON carries each basis's
    digest and the host's ISA flags (hazard C12)."""
    rc = bkz_quality.main(["--n", "64", "--betas", "20", "30", "--out",
                           str(tmp_path)])
    res = json.loads((tmp_path / "bkz_quality.json").read_text())
    assert rc == 0 and res["all_passed"] and res["monotone_in_beta"]
    assert [r["reduction"] for r in res["rows"]] == ["lll", "bkz-20",
                                                     "bkz-30"]
    for r in res["rows"][1:]:
        assert abs(r["rel_deviation"]) <= bkz_quality.REL_GATE
        assert r["delta0_model"] == _root_hermite(int(r["reduction"][4:]))
        assert len(r["digest"]) == 16 and len(r["gs_profile"]) == 64
    assert set(res["host"]) == {"cpu", "fma", "avx2", "avx512f"}
    assert "-march=native" in res["reduction_flags"]


def test_root_hermite_of_a_scaled_identity():
    """delta_0 of c I is 1 (b_1 = det^(1/n))."""
    assert bkz_quality.root_hermite(3.0 * np.eye(8)) == pytest.approx(1.0)


def test_quickstart_example():
    out = quickstart.main(["--cpu", "--n", "16", "--samples", "200"])
    assert tuple(out["points"].shape) == (200, 16) and out["finite"]
    assert 0.0 < out["acceptance"] <= 1.0
    assert 0.0 < out["spectral_gap"] <= 1.0
    assert 0.5 < out["std"] / out["sigma"] < 1.5


def test_ntru_falcon_example():
    out = ntru_falcon.main(["--cpu", "--n", "16"])
    assert all(out["keygen_checks"].values()) and out["dim"] == 32
    expect = out["sigma"] * np.sqrt(out["dim"])
    assert abs(out["mean_norm"] / expect - 1.0) < 0.05
    assert out["gibbs_distance"] <= out["babai_distance"] + 1e-9


@pytest.mark.parametrize("main", [debug_sigma.main, check_lattice.main])
def test_no_card_exits_2(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_asymptotics_fit_the_fastest_of_repeated_timings(tmp_path):
    """Hazard C13: each dimension is timed ASYMPTOTIC_REPS times after the
    first call; the rate and the exponent's fit take the fastest."""
    cfg = ScalingConfig(output_dir=str(tmp_path), asymptotic_dims=(32, 64))
    rows = dimension_scaling.asymptotic_analysis(cfg, device="cpu")
    for r in rows:
        assert r["reps"] == dimension_scaling.ASYMPTOTIC_REPS == 3
        assert len(r["rep_times_s"]) == 3
        assert r["sec_per_sample"] == min(r["rep_times_s"]) / r["chains"]
    alpha = np.polyfit(np.log([32, 64]),
                       np.log([r["sec_per_sample"] for r in rows]), 1)[0]
    assert rows[-1]["complexity_exponent_fit"] == pytest.approx(alpha)
    assert rows[-1]["complexity_gate"] == [0.0, 3.2]


def test_the_tools_and_examples_import_no_jax():
    """In a fresh interpreter where importing jax fails, the new tools and
    examples import and neither the JAX package nor `scripts` is loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import lattice_gaussian_mcmc_tpu_torch.tools.validate_scale
        import lattice_gaussian_mcmc_tpu_torch.tools.debug_sigma
        import lattice_gaussian_mcmc_tpu_torch.tools.check_lattice
        import lattice_gaussian_mcmc_tpu_torch.tools.bkz_quality
        import lattice_gaussian_mcmc_tpu_torch.examples.quickstart
        import lattice_gaussian_mcmc_tpu_torch.examples.ntru_falcon
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("lattice_gaussian_mcmc_tpu", "scripts")
               or "validate_pallas_scale" in m]
        assert not bad, bad
        print("isolated")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "isolated"
