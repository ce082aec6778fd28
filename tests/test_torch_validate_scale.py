"""`tools/validate_scale.py`, the port of `scripts/validate_pallas_scale.py`,
on the CPU: its gates against the script's own functions (pure numpy,
loaded from the script file), the whole tool at NTRU-16 (dimension 32)
with the kernels' plain versions in float32 against the per-row float64
route, and the gates' power against a wrong kernel side.

At dimension 32 the gates' "99% of the coordinates" is every one of the
32, so a moment gate false-alarms on ~10% of seeds even between two float64
runs (2 of 20 seeds of the hard regime's Klein draws; float32 plain against
float64 2 of 24, the same rate); the script's seeds (offset 0) trip one
coordinate's std in the hard regime's IMHK states and in Peikert's draws,
and offset 2 is the first that passes every gate. At dimension 1024, where
ten coordinates may stray, the script's seeds pass on the card."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    klein_precompute,
    klein_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.tools import validate_scale as vs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
# the tool at dimension 32: sizes cut from the script's for the CPU
SMALL = ["--n-kernel", "8192", "--n-oracle", "4096", "--smk-kernel", "4096",
         "--smk-oracle", "1024", "--smk-steps", "16", "--peikert-kernel",
         "8192", "--peikert-oracle", "4096"]
SMALL_SEED = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    """The JAX package's script as a module: its gates are pure numpy (it
    imports JAX only inside its phases)."""
    spec = importlib.util.spec_from_file_location(
        "validate_pallas_scale",
        os.path.join(REPO, "scripts", "validate_pallas_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lat16():
    return ntru_lattice(16, q=12289, seed=0,
                        cache_dir=os.path.join(REPO, "bench_cache"),
                        device="cpu")


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (bool, np.bool_)):
            assert bool(g) == bool(w), k
        else:
            assert abs(float(g) - float(w)) <= TOL * max(1.0, abs(float(w))), k


@pytest.mark.parametrize("case", ["same_law", "shifted", "wider"])
def test_moment_check_matches_the_script(script, case):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(4000, 24)).round()
    b = rng.normal(size=(900, 24)).round()
    if case == "shifted":
        b[:, 3] += 0.4
    elif case == "wider":
        b *= 1.3
    want = script.moment_check(a, b)
    assert_same(vs.moment_check(a, b), want)
    # the kernel side's tensors: the moments in float64 on their device
    assert_same(vs.moment_check(torch.as_tensor(a, dtype=torch.float32),
                                torch.as_tensor(b)), want)
    assert want["passed"] is (case == "same_law")


@pytest.mark.parametrize("case", ["degenerate", "spread", "far",
                                  "small_lambda"])
def test_ks_matches_the_script(script, case):
    rng = np.random.default_rng(12)
    b = 1352.5875 + rng.normal(scale=4.5e-5, size=800)
    if case == "degenerate":
        a = (1352.5875 + rng.normal(scale=1e-4, size=5000)).astype(np.float32)
    elif case == "spread":
        b = 279.1 + 0.37 * rng.normal(size=800)
        a = (279.1 + 0.37 * rng.normal(size=5000)).astype(np.float32)
    elif case == "far":
        b = 279.1 + 0.37 * rng.normal(size=800)
        a = (279.3 + 0.37 * rng.normal(size=5000)).astype(np.float32)
    else:
        b = rng.normal(size=800)
        a = b[:400].copy()
    want = script.ks_check(a, b)
    assert_same(vs.ks_check(a, b), want)
    assert vs.ks_2sample_np(a, b) == script.ks_2sample_np(a, b)
    assert want["passed"] is (case != "far")
    assert want["degenerate"] is (case == "degenerate")


@pytest.mark.parametrize("a_k, n_k, a_o, n_o", [
    (0.99997, 131072, 1.0, 2048), (0.7998, 131072, 0.8038, 2048),
    (0.5954, 32768, 0.5961, 1024), (0.60, 32768, 0.52, 1024)])
def test_acceptance_check_matches_the_script(script, a_k, n_k, a_o, n_o):
    k = {"acceptance": a_k, "n_chains": n_k}
    o = {"acceptance": a_o, "n_chains": n_o}
    want = script.acceptance_check(k, o)
    assert_same(vs.acceptance_check(k, o), want)


def test_f32_cond_mean_error_matches_the_script(script, lat16):
    pre = klein_precompute(lat16, 71.0)
    X, _ = klein_sample_batch(pre, 300, seed=4)
    args = (pre.U.numpy(), pre.cs.numpy(), pre.sigmas.numpy(), pre.window,
            X.float().numpy())
    want = script.f32_cond_mean_error(*args)
    assert_same(vs.f32_cond_mean_error(*args), want)
    assert want["passed"]


def test_the_tool_passes_every_regime_at_dimension_32(tmp_path):
    """The whole tool with --device cpu at NTRU-16: the plain versions of
    B1, B2, B4 and B5 in float32 against the per-row float64 route, every
    gate of the script, the float64 route launching nothing."""
    rc = vs.main(["--n-ring", "16", "--device", "cpu", "--out",
                  str(tmp_path), "--seed", str(SMALL_SEED), *SMALL])
    res = json.loads((tmp_path / "validation_dim32.json").read_text())
    assert rc == 0 and res["all_passed"] is True
    assert res["dim"] == 32 and res["f64_route_launches"] == 0
    assert res["rates_are_validation_harness_not_kernel"] is True
    assert res["seeds"] == {k: v + SMALL_SEED for k, v in vs.SEEDS.items()}
    for name in vs.REGIMES:
        assert res[name]["passed"] is True, name
    assert res["hard"]["log_weights"]["degenerate"] is False
    assert len(res["hard"]["log_weights_multi_seed"]) == 3
    assert res["smooth"]["window_tail_budget"] == vs.TAIL_BUDGET
    assert res["peikert"]["analytic_cov"]["frac_within_4se"] >= 0.99


def test_the_gates_have_power(lat16):
    """A kernel side drawn at 1.05 sigma fails the moments against the
    float64 route at sigma; the same draw at sigma passes. An acceptance
    shifted by 0.05 fails the acceptance gate."""
    sigma = 165.7
    pre = klein_precompute(lat16, sigma, tau=vs.TAU,
                           tail_budget=vs.TAIL_BUDGET)
    wide = klein_precompute(lat16, 1.05 * sigma, window=pre.window)
    orc = vs.oracle_klein_imhk(pre, 4096, 1024, 4, seed=3)
    good = vs.kernel_klein_imhk(pre, 8192, 4, seed=3)
    bad = vs.kernel_klein_imhk(wide, 8192, 0, seed=3)
    assert vs.moment_check(good["klein_coeffs"], orc["klein_coeffs"])[
        "passed"]
    assert not vs.moment_check(bad["klein_coeffs"], orc["klein_coeffs"])[
        "passed"]
    assert vs.acceptance_check(good, orc)["passed"]
    shifted = dict(good, acceptance=good["acceptance"] - 0.05)
    assert not vs.acceptance_check(shifted, orc)["passed"]


def test_no_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert vs.main(["--n-ring", "16", "--out", str(tmp_path)]) == 2
    assert not os.listdir(tmp_path)


def test_sizes_default_to_the_script():
    """The tool's defaults are the script's VAL_* defaults."""
    s = vs.Sizes()
    assert (s.n_kernel, s.n_oracle, s.n_steps, s.ks_seeds) == (
        131072, 8192, 16, 3)
    assert (s.smk_kernel, s.smk_oracle, s.smk_steps) == (32768, 1024, 48)
    assert (s.peikert_kernel, s.peikert_oracle) == (131072, 8192)
    assert vs.PEIKERT_ROUNDS == 4 and vs.ORACLE_CHUNK == 2048
    assert s.oracle_chains == 2048
    assert dataclasses.replace(s, n_oracle=1000).oracle_chains == 512
