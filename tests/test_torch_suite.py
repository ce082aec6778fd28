"""The port's benchmark suite on the CPU at a small size: every sampling row
at dimension 256 (the NTRU-128 key of seed 42 from `bench_cache/`) with 256
chains, and every row at 16 and 64 (the LLL-reduced q-ary basis, equal to
the JAX package's), no warm-up and one timed run, each with a finite
positive rate and a second moment near the law's; `bench_reduction` with
the JAX package's keys, and the reduction rows of `run_benchmarks`."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattice_gaussian_mcmc_tpu.experiments import benchmark as jbench
from lattice_gaussian_mcmc_tpu.experiments.configs import (
    BenchmarkConfig as JBenchmarkConfig,
)
from lattice_gaussian_mcmc_tpu.lattices import lattice_from_basis as jlattice
from lattice_gaussian_mcmc_tpu.lattices import qary_lattice as jqary
from lattice_gaussian_mcmc_tpu.reduction import lll_reduce as jlll
from lattice_gaussian_mcmc_tpu.samplers import PeikertSampler as JPeikert
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
    kw.setdefault("n_chains", 256)
    return BenchmarkConfig(output_dir=str(tmp_path), warmup_runs=0,
                           timed_runs=1,
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


# chains of the rows at 16 and 64: E||Bx||^2 / (dim sigma^2) over 16,384
# squared coordinates at either dimension
SMALL_CHAINS = {16: 1024, 64: 256}


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("algorithm", ["klein", "imhk", "peikert"])
def test_row_on_the_reduced_qary_basis(tmp_path, algorithm, n):
    """The rows below 256 run on LLL(qary_lattice(n, n/2, q=3329, seed))
    at sigma 1.5 max ||b*_i||, the JAX package's basis; the Peikert row
    below 128 is one capped batch, counted as the JAX package counts it."""
    B = SMALL_CHAINS[n]
    cfg = _cfg(tmp_path, n_chains=B)
    want = jlll(np.asarray(jqary(n, n // 2, q=3329, seed=cfg.seed,
                                 dtype=jnp.float64).basis))
    lat = benchmark.reduced_qary_lattice(n, cfg.seed, "cpu")
    np.testing.assert_array_equal(lat.basis.numpy(), want)
    row = benchmark.bench_algorithm(algorithm, n, cfg, device="cpu")
    assert row["algorithm"] == algorithm and row["dimension"] == n
    assert np.isfinite(row["samples_per_sec"]) and row["samples_per_sec"] > 0
    max_gs = float(lat.gs_norms.max())
    if algorithm == "peikert":
        s1 = float(np.linalg.norm(want, 2))
        jp = JPeikert(jlattice(want, dtype=jnp.float64), 3.0 * s1)
        per_run = min(B, max(256, 2 ** 28 // (n * jp.pre.window)))
        assert row["sigma"] == pytest.approx(3.0 * s1, rel=1e-12)
    else:
        per_run = B * {"klein": 8, "imhk": 16}[algorithm]
        assert row["sigma"] == pytest.approx(1.5 * max_gs, rel=1e-12)
        assert row["window"] == {16: 24, 64: 104}[n]
    assert row["samples_per_run"] == per_run
    assert abs(row["norm2_over_dim_sigma2"] - 1.0) < MOMENT_TOL, row


def test_bench_reduction_has_the_jax_packages_keys(tmp_path):
    cfg = _cfg(tmp_path)
    got = benchmark.bench_reduction(16, cfg)
    want = jbench.bench_reduction(16, JBenchmarkConfig(seed=cfg.seed))
    assert got.keys() == want.keys()
    assert got["native"] is True and got["dimension"] == 16
    assert got["lll_s"] > 0 and got["bkz20_s"] > 0
    with pytest.raises(ValueError, match="unknown algorithm"):
        benchmark.bench_algorithm("gibbs", 256, cfg, device="cpu")


def test_run_benchmarks_writes_results(tmp_path):
    cfg = _cfg(tmp_path, algorithms=("direct",), dimensions=(16, 64))
    payload = benchmark.run_benchmarks(cfg, device="cpu")
    assert payload["all_passed"] is True
    assert [r["dimension"] for r in payload["sampling"]] == [16, 64]
    assert [r["dimension"] for r in payload["reduction"]] == [16, 64]
    assert "not_run" not in payload
    with open(tmp_path / "benchmark_results.json") as f:
        assert json.load(f)["all_passed"] is True
