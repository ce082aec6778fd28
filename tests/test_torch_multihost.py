"""Two gloo processes on the CPU (the counterpart of the JAX package's
`tests/integration/test_multihost.py`): `sharded_imhk_chains`,
`sharded_imhk_blocked` and `sharded_peikert` on the JAX worker's problem,
each rank on its chain range, gathered; the digests must equal world size
1's bit for bit (the Philox stream is keyed by global chain id). And the
dry run (`parallel/dryrun.py`) at 1 and 2 ranks. Every spawn has its own
timeout (`runtime.run_ranks`)."""

import json

import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.parallel import _multihost_worker
from lattice_gaussian_mcmc_tpu_torch.parallel import dryrun
from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import make_mesh
from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import run_ranks

WORKER = "lattice_gaussian_mcmc_tpu_torch.parallel._multihost_worker"
SPAWN_TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_processes_give_world_size_1_digests(tmp_path):
    out = tmp_path / "digests.json"
    ranks = run_ranks(WORKER, 2, ["--device", "cpu", "--out", str(out)],
                      timeout=SPAWN_TIMEOUT_S)
    single = _multihost_worker.run_paths(make_mesh("cpu"), "small", 16, 4,
                                         2, imhk_samples=5)
    written = json.loads(out.read_text())
    for r in ranks:
        assert r["process_count"] == 2 and r["distributed"]
        assert r["backend"] == "gloo" and r["device"] == "cpu"
    assert [r["process_index"] for r in ranks] == [0, 1]
    assert written == ranks[0]
    for path in ("imhk_chains", "blocked", "peikert"):
        for r in ranks:
            assert r[path]["digest"] == single[path]["digest"], path
    for path in ("imhk_chains", "blocked"):
        assert ranks[0][path]["acceptance"] == single[path]["acceptance"]
        assert 0.0 < single[path]["acceptance"] <= 1.0
    assert ranks[0]["peikert"]["pooled_var_max"] == pytest.approx(
        single["peikert"]["pooled_var_max"], rel=1e-12)


def test_dryrun_one_and_two_ranks():
    """In law with the reference's record (MULTICHIP_r05.json: acceptance
    0.521 and R-hat 1.000 on 8 CPU devices): mixed accept/reject, a finite
    R-hat, the kernel path in (0, 1], a positive pooled variance. The
    per-row chains' numbers do not depend on the rank count."""
    one = dryrun.dryrun_rank(make_mesh("cpu"))
    two = dryrun.dryrun_multichip(2, "cpu", timeout=SPAWN_TIMEOUT_S)
    assert two["n_ranks"] == 2 and two["backend"] == "gloo"
    for r in (one, two):
        assert 0.02 < r["acceptance"] < 0.97
        assert 0.0 < r["kernel_acceptance"] <= 1.0
        assert r["peikert_var_max"] > 0.0
    assert two["acceptance"] == one["acceptance"]
    assert two["rhat"] == pytest.approx(one["rhat"], rel=1e-12)


def test_a_failed_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="exited"):
        run_ranks(WORKER, 2, ["--problem", "no_such_problem"],
                  timeout=SPAWN_TIMEOUT_S)
