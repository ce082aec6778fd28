"""The port's `experiments/klein_scaling.py` and `experiments/reporting.py`
against the JAX package's on the CPU: `marginal_tvd` equal on the same
inputs, the pipeline's sigma from the same LLL basis to 1e-12, the
pipeline at dimensions 8 and 16 passing its gates (B1's plain version in
float64), the tables' text equal to the JAX package's on the same result
JSON, and the figures written (matplotlib is on this host; the card's
host runs the tables only)."""

import json
import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import klein_scaling as j_ks
from lattice_gaussian_mcmc_tpu.experiments import reporting as j_rep
from lattice_gaussian_mcmc_tpu.lattices import (
    lattice_from_basis as j_lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu.reduction import lll_reduce as j_lll
from lattice_gaussian_mcmc_tpu_torch.experiments import klein_scaling
from lattice_gaussian_mcmc_tpu_torch.experiments import reporting


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("center,sigma,window", [(0.0, 2.0, None),
                                                  (3.4, 7.5, None),
                                                  (-1.2, 1.1, 30)])
def test_marginal_tvd_equals_jax(center, sigma, window):
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(center, sigma, 5000))
    assert klein_scaling.marginal_tvd(x, center, sigma, window) == \
        j_ks.marginal_tvd(x, center, sigma, window)


def test_run_klein_scaling_passes_on_the_cpu(tmp_path):
    rows = klein_scaling.run_klein_scaling((8, 16), output_dir=str(tmp_path),
                                           device="cpu")
    assert [r["dimension"] for r in rows] == [8, 16]
    assert all(r["passed"] and r["device"] == "cpu" for r in rows)
    out = json.loads((tmp_path / "klein_scaling.json").read_text())
    assert out["all_passed"] is True and len(out["rows"]) == 2
    for name in ("klein_scaling.csv", "klein_scaling_throughput.png",
                 "klein_scaling_tvd.pdf"):
        assert (tmp_path / name).exists()
    # sigma = 1.5 max ||b*_i|| of the same reduced basis as the JAX
    # pipeline's (its fixed-seed basis and the same LLL library)
    for r in rows:
        rng = np.random.default_rng(42)
        n = r["dimension"]
        while True:
            B = rng.integers(0, 51, (n, n)).astype(np.float64)
            if abs(np.linalg.det(B)) > 0.5:
                break
        gs = np.asarray(j_lattice_from_basis(j_lll(B)).gs_norms)
        assert r["sigma"] == pytest.approx(1.5 * gs.max(), rel=1e-12)


def _results(root):
    """A results tree with every file the tables and figures read."""
    def write(sub, name, obj):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name), "w") as f:
            json.dump(obj, f)

    write("crypto", "crypto_results.json", {
        "ntru_64": {"lattice": "ntru", "dimension": 128, "sigma": 4.25,
                    "acceptance": 0.9931, "spectral_gap": 0.91},
        "qary_64": {"lattice": "qary", "dimension": 64, "sigma": 31.0,
                    "acceptance": 1.0, "spectral_gap": 1.0}})
    write("convergence", "convergence_study.json", {
        "algorithm_comparison": [
            {"dimension": 2, "sigma_over_eta": s, "klein_tvd": 0.01 * s,
             "imhk_tvd": 0.02 / s, "acceptance": 0.5 + 0.1 * s,
             "spectral_gap_mc": 0.3} for s in (0.5, 1.0, 2.0)],
        "tvd_decay": [{"t": t, "tvd": 1.0 / t, "bound": 0.9 ** t}
                      for t in (10, 100, 1000)]})
    write("benchmark", "benchmark_results.json", {"sampling": [
        {"algorithm": a, "dimension": d, "samples_per_sec": 1e6 * d,
         "p50_s": 0.01, "acceptance": 1.0, "ess_per_sec": 1e5}
        for a in ("klein", "imhk") for d in (16, 64)]})
    write("sensitivity", "parameter_sensitivity.json", {"sigma_sweep": {
        "rows": [{"sigma_over_eta": s, "dimension": d, "acceptance": 0.9,
                  "spectral_gap": 0.5 * s} for s in (0.5, 1.0)
                 for d in (8, 16)]}})
    write("scaling", "dimension_scaling.json", {
        "throughput": [{"dimension": d, "samples_per_sec": 1e7 / d,
                        "sec_per_sample": d / 1e7} for d in (16, 32)],
        "inverse_delta": [{"dimension": d, "delta": 1.0 / d}
                          for d in (16, 32)]})


def test_tables_equal_jax_and_figures_written(tmp_path):
    root = str(tmp_path / "results")
    _results(root)
    t = reporting.generate_tables(root, str(tmp_path / "t"))
    j = j_rep.generate_tables(root, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in t] == \
        [os.path.basename(p) for p in j]
    assert len(t) == 6
    for a, b in zip(t, j):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    made = reporting.generate_figures(root, str(tmp_path / "f"))
    assert made == ["fig1_algorithm_comparison", "fig2_tvd_decay",
                    "fig3_throughput_scaling", "fig4_sigma_gap",
                    "fig6_sigma_heatmap", "fig5_delta_scaling",
                    "fig7_algorithm_panel"]
    for name in made:
        assert (tmp_path / "f" / f"{name}.png").exists()
