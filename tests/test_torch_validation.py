"""The port's Klein validation suite and convergence study: the TVD gate
and noise floor equal the JAX package's, the quick suite passes, and the
study at the JAX test's configuration (`tests/unit/test_experiments.py`
`test_convergence_study_artifact`) meets that test's asserts."""

import json

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import klein_validation as jkv
from lattice_gaussian_mcmc_tpu_torch.experiments import convergence_study
from lattice_gaussian_mcmc_tpu_torch.experiments import klein_validation
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ConvergenceConfig,
)
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import exact_pmf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sigma", [0.35, 2.0, 5.0])
def test_tvd_gate_and_noise_floor_equal_the_jax_packages(sigma):
    _, p = exact_pmf(sigma)
    assert klein_validation.tvd_noise_floor(p) == jkv.tvd_noise_floor(p)
    for n in (100, 10_000, 100_000):
        assert klein_validation.tvd_gate(p, n) == jkv.tvd_gate(p, n)
        assert klein_validation.tvd_gate(p, n, base=0.05) == \
            jkv.tvd_gate(p, n, base=0.05)


def test_quick_suite_passes(tmp_path):
    out = klein_validation.run_suite(output_dir=str(tmp_path), quick=True,
                                     device="cpu")
    assert out["all_passed"] is True, out
    assert [out[f"exp{k}"]["passed"] for k in range(1, 5)] == [True] * 4
    assert (tmp_path / "validation_results.json").exists()
    assert "exp4: PASS" in (tmp_path / "report.txt").read_text()


def test_convergence_study_meets_the_jax_tests_asserts(tmp_path):
    cfg = ConvergenceConfig(output_dir=str(tmp_path), dimensions=(2,),
                            sigma_factors=(2.0,), n_samples=2_000,
                            n_chains=2, burn_in=50, tvd_checkpoints=(10, 100))
    out = convergence_study.run_study(cfg, device="cpu")
    data = json.loads((tmp_path / "convergence_study.json").read_text())
    assert data["algorithm_comparison"], "no comparison rows"
    row = data["algorithm_comparison"][0]
    assert row["klein_tvd"] < 0.3
    assert abs(row["klein_tvd"] - row["imhk_tvd"]) < 0.1
    assert row["acceptance"] > 0.9
    assert data["tvd_decay"], "no decay curve"
    assert out["all_passed"] is True
    assert np.isfinite([r["gap_mc"] for r in out["spectral_analysis"]]).all()
