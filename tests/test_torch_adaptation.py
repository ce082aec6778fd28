"""The port's sigma adaptation (`samplers/adaptation.py`) and its driver
(`experiments/adaptation.py`) against the JAX package on the CPU.

Tolerances: the update rules and the burn-in bound are host float64
arithmetic, held exactly on the same payloads; the adaptation schedules,
fed the same scripted acceptances in both packages (window functions and
Klein start monkeypatched, no sampling), to 1e-12 relative (the timing keys
are left out); the driver is held to its own gates."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lattice_gaussian_mcmc_tpu.samplers.adaptation as j_ad
import lattice_gaussian_mcmc_tpu.samplers.klein_blocked as j_kb
from lattice_gaussian_mcmc_tpu.experiments import adaptation as j_exp
from lattice_gaussian_mcmc_tpu.lattices import ntru_lattice as j_ntru
from lattice_gaussian_mcmc_tpu_torch.experiments import adaptation as t_exp
from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
from lattice_gaussian_mcmc_tpu_torch.samplers import adaptation as t_ad

N_RING = 16      # NTRU ring degree of the small tests (dimension 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lattices():
    import os
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_cache")
    return (ntru_lattice(N_RING, seed=42, cache_dir=cache, device="cpu"),
            j_ntru(N_RING, seed=42, cache_dir=cache, dtype=jnp.float64))


@pytest.mark.parametrize("log_sigma,step,observed,target", [
    (0.3, 0, 0.2, 0.45), (-1.7, 5, 0.9, 0.45), (2.0, 11, 0.45, 0.9)])
def test_update_rules_equal_jax(log_sigma, step, observed, target):
    t = t_ad.robbins_monro_update(t_ad.AdaptationState(log_sigma, step),
                                  observed, target)
    j = j_ad.robbins_monro_update(j_ad.AdaptationState(log_sigma, step),
                                  observed, target)
    assert (t.log_sigma, t.step) == (j.log_sigma, j.step)
    assert t.sigma == j.sigma
    for t_ in (1, 7, 40):
        assert t_ad.dual_averaging_update(0.1, log_sigma, 0.3, t_, target,
                                          observed) == \
            j_ad.dual_averaging_update(0.1, log_sigma, 0.3, t_, target,
                                       observed)


@pytest.mark.parametrize("delta", [1e-15, 1e-4, 0.03, 0.5, 1.0])
def test_burn_in_from_gap_equals_jax(delta):
    for eps, cap in ((0.01, 100_000), (0.25, 50)):
        assert t_ad.estimate_burn_in_from_gap(delta, eps, cap) == \
            j_ad.estimate_burn_in_from_gap(delta, eps, cap)


def _strip_timing(history):
    return [{k: v for k, v in h.items()
             if k not in ("window_s", "samples_per_sec")} for h in history]


def _assert_histories_equal(th, jh):
    assert len(th) == len(jh)
    for a, b in zip(th, jh):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12), (k, a, b)


def test_smk_schedule_matches_jax_on_scripted_acceptances(lattices,
                                                          monkeypatch):
    """Both packages' adapt_sigma_smk, fed one scripted acceptance per
    window, give the same sigma_prop history and window schedule; the
    port's windows take consecutive, disjoint Philox step ranges after the
    Klein start (step 0)."""
    lat, jlat = lattices
    n = lat.n
    sigma = float(torch.max(lat.gs_norms))
    script = [0.1, 0.8, 0.3, 0.62, 0.5, 0.2, 0.47, 0.41, 0.44, 0.46]
    kw = dict(n_windows=len(script), window_steps=4, n_chains=64,
              warmup_windows=3, max_window_steps=32)

    it = iter(script)
    monkeypatch.setattr(j_kb, "klein_sample_batch_blocked",
                        lambda key, pre, B, block=32: (jnp.zeros((B, n)),
                                                       jnp.zeros(B)))
    monkeypatch.setattr(j_ad, "_smk_window_xla",
                        lambda key, pre_h, Q, R, X, steps: (X, next(it)))
    jst = j_ad.adapt_sigma_smk(jax.random.key(0), jlat, sigma, **kw)

    it = iter(script)
    ranges = []

    def window(pre_h, Q, R, X, n_steps, seed, step):
        ranges.append((step, n_steps))
        return X, next(it)

    monkeypatch.setattr(
        t_ad, "klein_sample_batch_blocked",
        lambda pre, B, seed=0, **k: (torch.zeros(B, n, dtype=torch.float64),
                                     torch.zeros(B, dtype=torch.float64)))
    monkeypatch.setattr(t_ad, "_smk_window_plain", window)
    tst = t_ad.adapt_sigma_smk(lat, sigma, **kw)

    _assert_histories_equal(_strip_timing(tst.history),
                            _strip_timing(jst.history))
    assert tst.log_sigma == pytest.approx(jst.log_sigma, rel=1e-12)
    assert [h["window_steps"] for h in tst.history] == [4] * 3 + [32] * 7
    starts = [s for s, _ in ranges]
    assert starts[0] == 1
    assert all(s + k == s2 for (s, k), s2 in zip(ranges, starts[1:]))


def test_imhk_schedule_matches_jax_on_scripted_acceptances(lattices,
                                                           monkeypatch):
    """adapt_sigma_imhk of both packages on the same scripted acceptance
    counts: the same sigma history (with its floor) and final sigma."""
    lat, jlat = lattices
    n, B, steps = lat.n, 32, 4
    sigma0 = 0.3 * float(torch.max(lat.gs_norms))   # below the floor
    counts = [0, 1, 4, 3, 2, 4, 4, 1]
    kw = dict(target_acceptance=0.7, n_windows=len(counts),
              window_steps=steps, n_chains=B)

    it = iter(counts)
    monkeypatch.setattr(j_ad, "klein_sample_batch_blocked",
                        lambda key, pre, B_, block: (jnp.zeros((B_, n)),
                                                     jnp.zeros(B_)))
    monkeypatch.setattr(
        j_ad, "imhk_steps_batch_blocked",
        lambda key, pre, X, lw, s, block: (X, lw, jnp.asarray(
            np.arange(B) % (next(it) + 1), jnp.int32)))
    jst = j_ad.adapt_sigma_imhk(jax.random.key(0), jlat, sigma0, **kw)

    it = iter(counts)
    monkeypatch.setattr(
        t_ad, "klein_sample_batch_blocked",
        lambda pre, B_, seed=0, **k: (torch.zeros(B_, n, dtype=torch.float64),
                                      torch.zeros(B_, dtype=torch.float64)))
    monkeypatch.setattr(
        t_ad, "imhk_steps_batch_blocked",
        lambda pre, X, lw, s, seed=0, step=1: (X, lw, torch.as_tensor(
            np.arange(B) % (next(it) + 1), dtype=torch.int32)))
    tst = t_ad.adapt_sigma_imhk(lat, sigma0, **kw)

    _assert_histories_equal(tst.history, jst.history)
    assert tst.sigma == pytest.approx(jst.sigma, rel=1e-12)


def test_adaptation_config_defaults_equal_jax():
    """Field for field; the JAX base config's dtype (and its n_devices and
    save_samples, which the port's configs do not carry) excepted."""
    t = dataclasses.asdict(t_exp.AdaptationConfig())
    j = dataclasses.asdict(j_exp.AdaptationConfig())
    assert set(j) - set(t) == {"dtype", "n_devices", "save_samples"}
    assert set(t) <= set(j)
    assert {k: j[k] for k in t} == t
    assert t["ntru_n"] == 512 and t["n_chains"] == 65_536
    assert (t["n_windows"], t["warmup_windows"], t["window_steps"],
            t["max_window_steps"]) == (16, 5, 8, 256)


def test_adapt_sigma_smk_on_the_plain_route(lattices):
    """The real plain route (a blocked Klein start and `smk_step`): the
    pooled acceptance approaches the target, chain states are integer
    coefficients of the right shape, and the history has the JAX keys."""
    lat, _ = lattices
    sigma = float(torch.max(lat.gs_norms))
    st = t_ad.adapt_sigma_smk(lat, sigma, n_windows=8, window_steps=4,
                              n_chains=256, warmup_windows=5,
                              max_window_steps=24, seed=3)
    assert [h["window_steps"] for h in st.history] == [4] * 5 + [24] * 3
    assert set(st.history[0]) == {"window", "sigma_prop", "acceptance",
                                  "window_steps", "window_s",
                                  "samples_per_sec"}
    assert abs(st.history[-1]["acceptance"] - 0.45) < 0.1
    assert st.coeffs.shape == (256, lat.n)
    torch.testing.assert_close(st.coeffs, torch.round(st.coeffs))
    assert math.isfinite(st.sigma)


def test_run_adaptation_passes_its_gates_on_the_cpu(tmp_path):
    """The driver at the JAX package's test size but 32-step late windows
    (NTRU-16, 512 chains, 8 windows of 4 steps then 32): all three gates."""
    import os
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_cache")
    cfg = t_exp.AdaptationConfig(output_dir=str(tmp_path), ntru_n=16,
                                 n_chains=512, n_windows=8, window_steps=4,
                                 max_window_steps=32, cache_dir=cache)
    out = t_exp.run_adaptation(cfg, device="cpu")
    assert out["all_passed"] is True, out["gates"]
    assert out["backend"] == "plain"
    assert out["window_schedule"] == [4] * 5 + [32] * 3
    assert out["acceptance_at_2x_width"] < out["acceptance_final"] \
        < out["acceptance_at_half_width"]
    assert (tmp_path / "adaptation_ntru.json").exists()
