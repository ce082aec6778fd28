"""The port's `parallel/` (mesh, collectives, runtime) against the JAX
package's on the CPU.

Tolerances: the collective diagnostics on the same float64 arrays to
1e-12 against the JAX functions on conftest's 8-device mesh (the
acceptance is the same float32 quotient, so equal); the sharded samplers
at world size 1 equal to the port's unsharded functions bit for bit; the
sharded samplers against the JAX package's on the 8-device mesh (other
random numbers) in law: acceptance and per-coordinate means within 4
standard errors. Each check runs with no process group and in a gloo
group of size 1 (a `file://` store)."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lattice_gaussian_mcmc_tpu import parallel as j_par
from lattice_gaussian_mcmc_tpu.lattices import (
    lattice_from_basis as j_lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu.parallel.collectives import (
    sharded_imhk_blocked as j_sharded_imhk_blocked,
)
from lattice_gaussian_mcmc_tpu.samplers import (
    klein_precompute as j_klein_precompute,
)
from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import peikert_cuda
from lattice_gaussian_mcmc_tpu_torch.parallel import collectives as col
from lattice_gaussian_mcmc_tpu_torch.parallel import mesh as pmesh
from lattice_gaussian_mcmc_tpu_torch.parallel import runtime
from lattice_gaussian_mcmc_tpu_torch.samplers import (
    imhk_chains,
    imhk_steps_batch_blocked,
    klein_precompute,
    klein_sample_batch,
    klein_sample_batch_blocked,
    peikert_precompute,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
N_SE = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["no_group", "gloo_1"])
def mesh(request, tmp_path):
    """The world-size-1 mesh, with no process group or in a gloo group of
    size 1 joined through a file store."""
    if request.param == "no_group":
        yield pmesh.make_mesh("cpu")
        return
    info = runtime.init_runtime(f"file://{tmp_path}/store", 1, 0,
                                device="cpu")
    try:
        assert info.backend == "gloo" and not info.distributed
        m = runtime.global_mesh("cpu")
        assert m.group is not None and m.size == 1
        yield m
    finally:
        runtime.shutdown_runtime()


def _on_jax_mesh(x):
    m = j_par.make_mesh()
    return jax.device_put(jnp.asarray(x), NamedSharding(m, P("chains"))), m


def test_global_moments_equal_jax(mesh):
    x = np.random.default_rng(0).normal(1.0, 2.0, (64, 10, 3))
    xj, jm = _on_jax_mesh(x)
    jmean, jstd = j_par.global_moments(xj, jm)
    mean, std = col.global_moments(torch.from_numpy(x), mesh)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=TOL,
                               atol=TOL)


def test_global_gelman_rubin_equal_jax(mesh):
    x = np.random.default_rng(1).normal(size=(16, 100))
    x[:4] += 0.3                     # some between-chain variance
    xj, jm = _on_jax_mesh(x)
    r = col.global_gelman_rubin(torch.from_numpy(x), mesh)
    np.testing.assert_allclose(r, float(j_par.global_gelman_rubin(xj, jm)),
                               rtol=TOL, atol=TOL)


def test_global_acceptance_equal_jax(mesh):
    acc = np.arange(8, dtype=np.int32) * 3
    tot = np.full(8, 37, dtype=np.int32)
    jm = j_par.make_mesh()
    want = float(j_par.global_acceptance(jnp.asarray(acc), jnp.asarray(tot),
                                         jm))
    assert col.global_acceptance(torch.from_numpy(acc),
                                 torch.from_numpy(tot), mesh) == want
    # the port's ChainState counts one number of steps for every chain
    assert col.global_acceptance(torch.from_numpy(acc), 37, mesh) == want


def _pre_2d(sigma, dtype=torch.float64):
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                             dtype=dtype, device="cpu")
    return klein_precompute(lat, sigma)


def test_sharded_klein_batch_equals_unsharded(mesh):
    pre = _pre_2d(1.5)
    X, lw = col.sharded_klein_batch(pre, 64, mesh, seed=3)
    Xu, lwu = klein_sample_batch(pre, 64, seed=3)
    assert torch.equal(X, Xu) and torch.equal(lw, lwu)


def test_sharded_imhk_chains_equals_unsharded(mesh):
    pre = _pre_2d(0.5)
    coeffs, log_ws, stats = col.sharded_imhk_chains(pre, 16, 10, mesh,
                                                    burn_in=2, seed=5)
    cu, lu, state = imhk_chains(pre, 16, 10, burn_in=2, seed=5)
    assert torch.equal(coeffs, cu) and torch.equal(log_ws, lu)
    acc = int(state.accepted.sum())
    assert stats["acceptance_rate"] == float(
        np.float32(acc) / np.float32(16 * state.steps))
    assert stats["n_total"] == 160
    x = cu.double().reshape(-1, 2)
    torch.testing.assert_close(stats["mean"], x.mean(0), rtol=TOL, atol=TOL)
    torch.testing.assert_close(stats["std"], x.std(0, correction=0),
                               rtol=1e-10, atol=1e-10)


def test_sharded_imhk_blocked_equals_unsharded(mesh):
    pre = _pre_2d(0.5)
    X, lw, acc, rate = col.sharded_imhk_blocked(pre, 64, 8, mesh, seed=7)
    X0, lw0 = klein_sample_batch_blocked(pre, 64, seed=7, step=0)
    Xu, lwu, accu = imhk_steps_batch_blocked(pre, X0, lw0, 8, seed=7,
                                             step=1)
    assert torch.equal(X, Xu) and torch.equal(lw, lwu)
    assert torch.equal(acc, accu)
    assert rate == float(np.float32(int(accu.sum())) / np.float32(64 * 8))


def test_sharded_peikert_equals_unsharded(mesh):
    lat = lattice_from_basis(np.array([[2.0, 1.0], [0.0, 3.0]]),
                             device="cpu")
    ops = peikert_cuda.peikert_operands(peikert_precompute(lat, 12.0),
                                        window=16)
    X, mean, var = col.sharded_peikert(ops, 32, mesh, n_rounds=3, seed=9)
    ring = peikert_cuda.peikert_rounds(ops, 32, 3, seed=9)
    want = peikert_cuda.ring_coeffs(ops, ring).transpose(0, 1).reshape(96, 2)
    assert torch.equal(X, want)
    xd = want.double()
    torch.testing.assert_close(mean, xd.mean(0), rtol=TOL, atol=TOL)
    torch.testing.assert_close(var, xd.var(0, correction=0), rtol=1e-10,
                               atol=1e-10)


def _within_se(a, b, sd_a, sd_b, n_a, n_b):
    se = np.sqrt(sd_a ** 2 / n_a + sd_b ** 2 / n_b)
    assert np.all(np.abs(a - b) <= N_SE * se + 1e-12), (a, b, se)


def _jax_pre_2d(sigma):
    lat = j_lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]),
                               dtype=jnp.float64)
    return j_klein_precompute(lat, sigma)


def test_sharded_imhk_chains_law_equals_jax():
    """Acceptance and the final states' per-coordinate means against the
    JAX sharded chains on the 8-device mesh, within 4 standard errors."""
    C, T = 512, 8
    jcoeffs, _, jstats = j_par.sharded_imhk_chains(
        jax.random.key(0), _jax_pre_2d(0.5), n_chains=C, n_samples=T,
        mesh=j_par.make_mesh())
    jc = np.asarray(jcoeffs)[:, -1]
    coeffs, _, stats = col.sharded_imhk_chains(_pre_2d(0.5), C, T,
                                               pmesh.make_mesh("cpu"))
    tc = coeffs[:, -1].numpy()
    pa, pj = stats["acceptance_rate"], float(jstats["acceptance_rate"])
    _within_se(pa, pj, np.sqrt(pa * (1 - pa)), np.sqrt(pj * (1 - pj)),
               C * T, C * T)
    _within_se(tc.mean(0), jc.mean(0), tc.std(0), jc.std(0), C, C)


def test_sharded_imhk_blocked_law_equals_jax():
    """The kernel path's plain version against the JAX
    `sharded_imhk_blocked` on the 8-device mesh, within 4 standard
    errors."""
    C, S = 2048, 4
    jX, _, jacc = j_sharded_imhk_blocked(jax.random.key(1), _jax_pre_2d(0.5),
                                         n_chains=C, n_steps=S,
                                         mesh=j_par.make_mesh(), block=2)
    X, _, _, acc = col.sharded_imhk_blocked(_pre_2d(0.5), C, S,
                                            pmesh.make_mesh("cpu"), seed=1)
    jX, tX, pj = np.asarray(jX), X.numpy(), float(jacc)
    _within_se(acc, pj, np.sqrt(acc * (1 - acc)), np.sqrt(pj * (1 - pj)),
               C * S, C * S)
    _within_se(tX.mean(0), jX.mean(0), tX.std(0), jX.std(0), C, C)


def test_shard_range_splits_chains_and_checks_c6():
    ranges = [pmesh.shard_range(12, pmesh.ChainMesh(None, r, 3,
                                                     torch.device("cpu")))
              for r in range(3)]
    assert [list(r) for r in ranges] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                         [8, 9, 10, 11]]
    with pytest.raises(ValueError, match="world size 3 must divide"):
        pmesh.shard_range(10, pmesh.ChainMesh(None, 0, 3,
                                              torch.device("cpu")))


def test_init_runtime_single_process_and_failed_init(monkeypatch):
    for k in ("LATTICE_MCMC_COORDINATOR", "LATTICE_MCMC_NUM_PROCESSES",
              "LATTICE_MCMC_PROCESS_ID", "MASTER_ADDR", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    info = runtime.init_runtime(device="cpu")
    assert not info.distributed and info.process_count == 1
    assert info.backend is None and runtime.is_primary()
    m = runtime.global_mesh("cpu")
    assert m.group is None and m.size == 1
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(runtime.all_processes_array(x, m),
                                  x.numpy())
    with pytest.raises(ValueError, match="needs num_processes"):
        runtime.init_runtime("127.0.0.1:1", device="cpu")


@pytest.mark.parametrize("launch, local_world, cards, device, want", [
    # the LATTICE_MCMC_* launch: one process a host, each with its card
    ("coordinator", None, 1, "cuda", "nccl"),
    # run_ranks: two ranks on one host share its card
    ("coordinator", "2", 1, "cuda", "gloo"),
    ("coordinator", "2", 2, "cuda", "nccl"),
    ("coordinator", None, 1, "cpu", "gloo"),
    # env:// without a local count: every rank on this host
    ("env", None, 1, "cuda", "gloo"),
    ("env", None, 2, "cuda", "nccl"),
    ("env", "1", 1, "cuda", "nccl"),
])
def test_backend_by_launch_local_ranks_and_cards(monkeypatch, launch,
                                                 local_world, cards, device,
                                                 want):
    for k in ("LATTICE_MCMC_COORDINATOR", "LATTICE_MCMC_NUM_PROCESSES",
              "LATTICE_MCMC_PROCESS_ID", "MASTER_ADDR", "RANK",
              "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(runtime, "_rank_device",
                        lambda dev, rank: torch.device(device))
    got = {}
    monkeypatch.setattr(runtime.dist, "init_process_group",
                        lambda backend, **kw: got.update(backend=backend))
    if launch == "coordinator":
        runtime.init_runtime("127.0.0.1:1", 2, 1)
    else:
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("RANK", "1"),
                     ("WORLD_SIZE", "2")):
            monkeypatch.setenv(k, v)
        runtime.init_runtime()
    assert got["backend"] == want


def test_run_ranks_sets_each_ranks_environment(monkeypatch):
    envs = []

    class Done:
        returncode = 0

        def __init__(self, cmd, cwd, env, stdout, stderr):
            envs.append(env)
            stdout.write('{"rank": %s}\n' % env["LATTICE_MCMC_PROCESS_ID"])

        def poll(self):
            return 0

    monkeypatch.setattr(runtime.subprocess, "Popen", Done)
    out = runtime.run_ranks("some.module", 3, ["x"], timeout=5.0)
    assert out == [{"rank": 0}, {"rank": 1}, {"rank": 2}]
    assert {e["LATTICE_MCMC_NUM_PROCESSES"] for e in envs} == {"3"}
    assert {e["LOCAL_WORLD_SIZE"] for e in envs} == {"3"}
    assert {e["OMP_NUM_THREADS"] for e in envs} == {"1"}
    assert len({e["LATTICE_MCMC_COORDINATOR"] for e in envs}) == 1


def test_write_metrics_on_the_primary(tmp_path):
    path = tmp_path / "sub" / "m.json"
    runtime.write_metrics(str(path), {"a": np.float32(1.5)})
    assert path.read_text().strip().startswith("{")


def test_parallel_models_and_reporting_import_no_jax():
    """In a fresh interpreter where importing jax fails, the new modules
    import and the JAX package is never loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import lattice_gaussian_mcmc_tpu_torch.parallel
        import lattice_gaussian_mcmc_tpu_torch.parallel.runtime
        import lattice_gaussian_mcmc_tpu_torch.parallel.dryrun
        import lattice_gaussian_mcmc_tpu_torch.parallel._multihost_worker
        import lattice_gaussian_mcmc_tpu_torch.experiments.mesh_scaling
        import lattice_gaussian_mcmc_tpu_torch.experiments._mesh_scaling_worker
        import lattice_gaussian_mcmc_tpu_torch.experiments._process_scaling_worker
        import lattice_gaussian_mcmc_tpu_torch.experiments.klein_scaling
        import lattice_gaussian_mcmc_tpu_torch.experiments.reporting
        import lattice_gaussian_mcmc_tpu_torch.models
        import lattice_gaussian_mcmc_tpu_torch.utils.checkpoint
        import lattice_gaussian_mcmc_tpu_torch.utils.profiling
        bad = [m for m in sys.modules
               if m == "lattice_gaussian_mcmc_tpu"
               or m.startswith("lattice_gaussian_mcmc_tpu.")
               or m == "matplotlib"]
        assert not bad, bad
        print("isolated")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "isolated" in r.stdout
