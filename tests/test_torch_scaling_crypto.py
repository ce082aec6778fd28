"""The port's dimension-scaling, cryptographic and parameter-sensitivity
drivers against the JAX package on the CPU.

Tolerances: the integer bases of the extra lattice families and of the
crypto suite at the CLI's quick sizes are held exactly (the same numpy
streams and the same reduction library); the theta products to 1e-6
relative (the JAX function evaluates log rho_Z in float32); the drivers, at
their quick configs on the CPU (the blocked route's plain versions), to
their own gates."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.experiments import configs as j_configs
from lattice_gaussian_mcmc_tpu.experiments import cryptographic as j_crypto
from lattice_gaussian_mcmc_tpu.experiments import dimension_scaling as j_ds
from lattice_gaussian_mcmc_tpu_torch.experiments import configs
from lattice_gaussian_mcmc_tpu_torch.experiments import (
    cryptographic,
    dimension_scaling,
    parameter_sensitivity,
)
from lattice_gaussian_mcmc_tpu_torch.tools import reduction_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "bench_cache")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [3, 8, 32])
def test_extra_lattice_families_equal_jax(n):
    for t_f, j_f in ((dimension_scaling.checkerboard_lattice,
                      j_ds.checkerboard_lattice),
                     (dimension_scaling.root_lattice_an,
                      j_ds.root_lattice_an)):
        t = t_f(n, device="cpu")
        j = j_f(n, dtype=jnp.float64)
        np.testing.assert_array_equal(t.basis.numpy(), np.asarray(j.basis))
        assert t.name == j.name and t.meta == j.meta


def test_theta_products_match_jax():
    t = dimension_scaling.theta_product_analysis()
    j = j_ds.theta_product_analysis()
    assert len(t) == len(j) == 16
    for a, b in zip(t, j):
        assert (a["dimension"], a["sigma"]) == (b["dimension"], b["sigma"])
        for k in ("log_partition", "log_partition_per_dim"):
            assert a[k] == pytest.approx(b[k], rel=1e-6)


def _quick_crypto(tmp_path):
    # the CLI's --quick crypto config
    return dict(output_dir=str(tmp_path), ntru_n=(32,), qary_dims=(32,),
                n_samples=2_000, n_chains=256)


def test_crypto_suite_bases_equal_jax(tmp_path, monkeypatch):
    """The quick suite's lattices, names and integer bases (identity,
    checkerboard, the LLL + BKZ-20 reduced q-ary basis, NTRU-32) equal
    the JAX package's."""
    monkeypatch.chdir(REPO)   # the JAX suite reads bench_cache/ relative
    t = cryptographic.build_lattice_suite(
        configs.CryptoConfig(cache_dir=CACHE, **_quick_crypto(tmp_path)),
        device="cpu")
    j = j_crypto.build_lattice_suite(
        j_configs.CryptoConfig(**_quick_crypto(tmp_path)), jnp.float64)
    assert list(t) == list(j)
    for name in t:
        np.testing.assert_array_equal(t[name].basis.numpy(),
                                      np.asarray(j[name].basis), name)
        assert t[name].name == j[name].name
    assert t["qary_32"].meta["basis_digest"] == reduction_digest.digest(
        np.asarray(j["qary_32"].basis))


def test_run_crypto_suite_gates_and_resume(tmp_path):
    """The quick suite passes its gates; a run that finds a checkpoint
    resumes from it and gives the same rows as the uninterrupted run."""
    cfg = configs.CryptoConfig(cache_dir=CACHE, checkpoint_every=1,
                               **_quick_crypto(tmp_path / "a"))
    full = cryptographic.run_crypto_suite(cfg, device="cpu")
    assert list(full) == ["identity_32", "checkerboard_32", "qary_32",
                          "ntru_32"]
    assert all(r["passed"] for r in full.values()), full
    assert not (tmp_path / "a" / "crypto_checkpoint.json").exists()
    # a run cut after two lattices: its checkpoint, then the resumed run
    cfg_b = configs.CryptoConfig(cache_dir=CACHE,
                                 **_quick_crypto(tmp_path / "b"))
    os.makedirs(cfg_b.output_dir)
    part = {k: full[k] for k in ("identity_32", "checkerboard_32")}
    with open(os.path.join(cfg_b.output_dir, "crypto_checkpoint.json"),
              "w") as f:
        json.dump(part, f)
    resumed = cryptographic.run_crypto_suite(cfg_b, device="cpu")
    assert resumed == json.loads(json.dumps(full))
    assert not os.path.exists(os.path.join(cfg_b.output_dir,
                                           "crypto_checkpoint.json"))
    sens = cryptographic.sigma_sensitivity(cfg, device="cpu")
    assert sens[-1]["gate"] == "sigma_monotone" and sens[-1]["passed"]


def test_run_scaling_quick_passes_its_gates(tmp_path):
    """The CLI's quick scaling config on the CPU: every analysis, the
    complexity gate, the plain route's figures in place of the card's."""
    cfg = configs.ScalingConfig(output_dir=str(tmp_path),
                                dimensions=(16, 32), n_samples=2_000,
                                n_chains_grid=(256, 1024),
                                asymptotic_dims=(32, 64))
    out = dimension_scaling.run_scaling(cfg, device="cpu")
    assert out["all_passed"] is True
    assert [r["dimension"] for r in out["asymptotics"]] == [32, 64]
    for r in out["asymptotics"]:
        assert r["route"] == "plain" and r["kernel_resources"] is None
        assert r["chains"] == dimension_scaling.ASYMPTOTIC_CHAINS_CPU
        assert r["samples_per_sec"] > 0 and "peak_rss_mb" in r
    assert [r["dimension"] for r in out["inverse_delta"]] == [16, 32]
    assert all(0 < r["delta"] <= 1 for r in out["inverse_delta"])
    assert all(0 <= r["acceptance"] <= 1
               for r in out["condition_sensitivity"])
    assert (tmp_path / "dimension_scaling.json").exists()


def test_run_sensitivity_quick_passes_its_gates(tmp_path):
    cfg = configs.SensitivityConfig(output_dir=str(tmp_path), dimension=8,
                                    sweep_dimensions=(4, 8),
                                    sigma_grid_size=7, n_samples=3_000)
    out = parameter_sensitivity.run_sensitivity(cfg, device="cpu")
    assert out["all_passed"] is True
    assert len(out["sigma_sweep"]["rows"]) == 14
    assert [r["reduction"] for r in out["reduction_sensitivity"]] == \
        ["none", "lll", "bkz"]
    assert [r["center"] for r in out["center_sensitivity"]] == \
        ["origin", "random", "deep_hole"]
