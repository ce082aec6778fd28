"""The port's `utils/checkpoint.py` and `utils/profiling.py` against the
JAX package's on the CPU: checkpoints cross between the packages both
ways in the npz layout (the JAX package writes it where orbax is missing,
as on the card's host: here orbax's import is made to fail); the
statistics, timer, trace and cost counter under the JAX keys."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu.utils import checkpoint as j_ckpt
from lattice_gaussian_mcmc_tpu.utils import profiling as j_prof
from lattice_gaussian_mcmc_tpu_torch.utils import checkpoint as t_ckpt
from lattice_gaussian_mcmc_tpu_torch.utils import profiling as t_prof


def _state(rng):
    return {"coeffs": rng.integers(-9, 9, (8, 5)).astype(np.float32),
            "log_w": rng.normal(size=8),
            "accepted": rng.integers(0, 4, 8).astype(np.int32),
            "step": 12}


@pytest.fixture
def no_orbax(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_jax_checkpoint_restores_in_the_port(tmp_path, no_orbax):
    s = _state(np.random.default_rng(0))
    j_ckpt.save_checkpoint(str(tmp_path), {k: jnp.asarray(v)
                                           for k, v in s.items()}, 3)
    j_ckpt.save_checkpoint(str(tmp_path), {k: jnp.asarray(v)
                                           for k, v in s.items()}, 7)
    template = {"coeffs": torch.zeros(8, 5), "log_w": torch.zeros(8),
                "accepted": torch.zeros(8, dtype=torch.int32), "step": 0}
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 7
    for k in ("coeffs", "log_w", "accepted"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), s[k])
    assert got["step"] == 12 and isinstance(got["step"], int)
    assert t_ckpt.restore_checkpoint(str(tmp_path), template, step=3)[1] == 3


def test_port_checkpoint_restores_in_jax(tmp_path, no_orbax):
    s = _state(np.random.default_rng(1))
    state = ({k: torch.from_numpy(np.asarray(v)) if k != "step" else v
              for k, v in s.items()}, [torch.arange(3.0), None])
    path = t_ckpt.save_checkpoint(str(tmp_path), state, 5)
    assert path.endswith("step_5.npz")
    template = ({k: jnp.zeros(1) for k in s}, [jnp.zeros(3), None])
    got, step = j_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 5
    for k in s:
        np.testing.assert_array_equal(np.asarray(got[0][k]), s[k])
    np.testing.assert_array_equal(np.asarray(got[1][0]), [0.0, 1.0, 2.0])
    # and back in the port, structure and all
    back, _ = t_ckpt.restore_checkpoint(str(tmp_path), state)
    assert back[1][1] is None and torch.equal(back[1][0], state[1][0])


def test_restore_of_nothing_and_of_an_orbax_directory(tmp_path):
    assert t_ckpt.restore_checkpoint(str(tmp_path / "none"), {}) == (None, -1)
    (tmp_path / "step_4").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(1)})


def test_sampling_stats_and_timed_equal_jax():
    t, j = t_prof.SamplingStats(), j_prof.SamplingStats()
    for s in (t, j):
        s.acceptance_rate, s.ess = 0.4, 50.0
    with t_prof.timed(t, 100, device="cpu"):
        sum(range(1000))
    j.samples_generated, j.time_elapsed = 100, t.time_elapsed
    assert t.as_dict() == j.as_dict()
    assert t.samples_per_second == pytest.approx(100 / t.time_elapsed)
    assert t_prof.SamplingStats().as_dict() == j_prof.SamplingStats(
        ).as_dict()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.profile_trace(None) as off:
        assert off is None
    with t_prof.profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    text = (tmp_path / "trace.json").read_text()
    assert "traceEvents" in text


def test_compiled_cost_keys_and_matmul_flops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    t = t_prof.compiled_cost(lambda x, y: x @ y, a, b)
    j = j_prof.compiled_cost(lambda x, y: x @ y, jnp.ones((8, 16)),
                             jnp.ones((16, 4)))
    assert set(t) == set(j) == {"flops", "bytes_accessed", "transcendentals"}
    assert t["flops"] == 2 * 8 * 16 * 4 == j["flops"]
    assert t["bytes_accessed"] is None and t["transcendentals"] is None
    assert t_prof.compiled_cost(lambda x: x + 1, a)["flops"] is None
    assert "peak_rss_mb" in t_prof.memory_snapshot()
