"""The port's benchmark suite on the CPU at a small size: every sampling row
at dimension 256 (the NTRU-128 key of seed 42 from `bench_cache/`) with 256
chains, no warm-up and one timed run, each with a finite positive rate and
a second moment near the law's; the rows that need `reduction/` raise."""

import json
import os

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.experiments import benchmark
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    BenchmarkConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# E||Bx||^2 / (dim sigma^2) over 256 draws of dimension 256 (65,536
# squared coordinates): ~1 at the law, within a few per cent
MOMENT_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, **kw):
    return BenchmarkConfig(output_dir=str(tmp_path), n_chains=256,
                           warmup_runs=0, timed_runs=1,
                           cache_dir=os.path.join(REPO, "bench_cache"), **kw)


@pytest.mark.parametrize("algorithm", ["klein", "imhk", "direct", "peikert"])
def test_row_at_dimension_256(tmp_path, algorithm):
    row = benchmark.bench_algorithm(algorithm, 256, _cfg(tmp_path),
                                    device="cpu")
    assert row["algorithm"] == algorithm and row["dimension"] == 256
    assert np.isfinite(row["samples_per_sec"]) and row["samples_per_sec"] > 0
    per_run = {"klein": 256 * 8, "imhk": 256 * 16, "direct": 256 * 256,
               "peikert": 256 * 8}[algorithm]
    assert row["samples_per_run"] == per_run
    assert row["p50_s"] > 0 and "peak_rss_mb" in row
    assert abs(row["norm2_over_dim_sigma2"] - 1.0) < MOMENT_TOL, row


def test_rows_that_need_reduction_raise(tmp_path):
    cfg = _cfg(tmp_path)
    for alg in ("klein", "imhk", "peikert"):
        with pytest.raises(NotImplementedError, match="A14"):
            benchmark.bench_algorithm(alg, 64, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        benchmark.bench_reduction(64, cfg)
    with pytest.raises(ValueError, match="unknown algorithm"):
        benchmark.bench_algorithm("gibbs", 256, cfg, device="cpu")


def test_run_benchmarks_writes_results(tmp_path):
    cfg = _cfg(tmp_path, algorithms=("direct",), dimensions=(16, 64))
    payload = benchmark.run_benchmarks(cfg, device="cpu")
    assert payload["all_passed"] is True
    assert [r["dimension"] for r in payload["sampling"]] == [16, 64]
    assert "A14" in payload["not_run"]["reduction"]
    with open(tmp_path / "benchmark_results.json") as f:
        assert json.load(f)["all_passed"] is True
