"""The port's `reduction/` against the JAX package's: its own copy of the
C++ source, the same integer bases out of LLL and BKZ (native library and
pure-Python fallback) on the seeds and shapes of
`tests/unit/test_reduction.py`, the quality analytics to 1e-12, the same
`sampling_reduce` strategy, and a library build that two processes can
run at once."""

import filecmp
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from lattice_gaussian_mcmc_tpu import reduction as jr
from lattice_gaussian_mcmc_tpu.lattices.qary import qary_basis
from lattice_gaussian_mcmc_tpu.reduction import build as jbuild
from lattice_gaussian_mcmc_tpu.reduction import lll as jlll
from lattice_gaussian_mcmc_tpu_torch import reduction as tr
from lattice_gaussian_mcmc_tpu_torch.lattices import qary_lattice
from lattice_gaussian_mcmc_tpu_torch.reduction import build as tbuild
from lattice_gaussian_mcmc_tpu_torch.reduction import lll as tlll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# analytics of the same integer basis: the same numpy calls on both sides
ANALYTICS_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    """The JAX package's library, which its loader builds beside its source
    at first use: another test process may be writing it, so a load that
    found a partial file is tried again."""
    for _ in range(30):
        if jbuild.load_library() is not None:
            return
        jbuild._tried = False
        time.sleep(1.0)
    pytest.fail("the JAX package's reduction library did not load")


def _rand_basis(rng, n=12, lo=-30, hi=31):
    while True:
        B = rng.integers(lo, hi, size=(n, n)).astype(np.int64)
        if abs(np.linalg.det(B.astype(float))) > 1:
            return B


def _cases():
    """The bases of tests/unit/test_reduction.py, each from a fresh
    default_rng(42) as its `rng` fixture gives."""
    def rng():
        return np.random.default_rng(42)

    qary = qary_basis(rng().integers(0, 97, size=(12, 12)), 97)
    r20 = rng()
    return {"rand12": _rand_basis(rng()), "rand8": _rand_basis(rng(), 8),
            "rand6": _rand_basis(rng(), 6), "qary97": qary,
            **{f"rand20_{k}": _rand_basis(r20, 20) for k in range(4)}}


CASES = _cases()


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(tbuild.SRC, jbuild._SRC, shallow=False)
    assert tr.native_available()
    assert os.path.dirname(tbuild.library_path()) == os.path.join(
        REPO, "lattice_gaussian_mcmc_tpu_torch", "_build")


@pytest.mark.parametrize("name", sorted(CASES))
def test_lll_bases_equal_the_jax_packages(name):
    B = CASES[name]
    np.testing.assert_array_equal(tr.lll_reduce(B), jr.lll_reduce(B))
    if B.shape[0] <= 12:
        np.testing.assert_array_equal(tr.lll_reduce(B, force_python=True),
                                      jr.lll_reduce(B, force_python=True))
        np.testing.assert_array_equal(tlll.lll_reduce_python(B.T, 0.75),
                                      jlll.lll_reduce_python(B.T, 0.75))


@pytest.mark.parametrize("name", ["qary97", "rand20_0", "rand20_3"])
def test_bkz_bases_equal_the_jax_packages(name):
    B = CASES[name]
    R = jr.lll_reduce(B)
    np.testing.assert_array_equal(tr.bkz_reduce(R, beta=10, max_tours=3),
                                  jr.bkz_reduce(R, beta=10, max_tours=3))
    np.testing.assert_array_equal(
        tr.bkz_reduce(B, beta=20, max_tours=2, progressive=True),
        jr.bkz_reduce(B, beta=20, max_tours=2, progressive=True))


def test_lll_at_the_qary_128_case_equals_the_jax_packages():
    from lattice_gaussian_mcmc_tpu.lattices import qary_lattice as jqary
    B = qary_lattice(128, 64, q=3329, seed=42, device="cpu").basis.numpy()
    np.testing.assert_array_equal(B, np.asarray(jqary(128, 64, q=3329,
                                                      seed=42).basis))
    np.testing.assert_array_equal(tr.lll_reduce(B, delta=0.99),
                                  jr.lll_reduce(B, delta=0.99))
    np.testing.assert_array_equal(tlll.gso_profile_native(B),
                                  jlll.gso_profile_native(B))
    assert tlll.is_lll_reduced(tr.lll_reduce(B))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=ANALYTICS_TOL, atol=ANALYTICS_TOL)


@pytest.mark.parametrize("name", ["rand6", "rand8", "qary97"])
def test_analytics_equal_the_jax_packages(name):
    B = CASES[name]
    R = tr.lll_reduce(B)
    _close(tr.hermite_factor(B), jr.hermite_factor(B))
    _close(tr.orthogonality_defect(R), jr.orthogonality_defect(R))
    got, want = tr.basis_quality_profile(B), jr.basis_quality_profile(B)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    got, want = tr.compare_bases(B, R), jr.compare_bases(B, R)
    for part in ("original", "reduced"):
        for k in want[part]:
            _close(got[part][k], want[part][k])
    _close(got["max_gs_improvement"], want["max_gs_improvement"])
    _close(got["defect_improvement"], want["defect_improvement"])
    np.testing.assert_array_equal(tr.lll_with_removals(B, keep=5),
                                  jr.lll_with_removals(B, keep=5))
    np.testing.assert_array_equal(tr.local_gs_swap_improve(B),
                                  jr.local_gs_swap_improve(B))
    assert tr.reduction_cost_model(64, beta=20) == \
        jr.reduction_cost_model(64, beta=20)
    for kind in ("identity", "ntru", "qary", "module", "custom"):
        for n in (64, 256, 1024):
            assert tr.recommend_strategy(kind, n) == \
                jr.recommend_strategy(kind, n)


@pytest.mark.parametrize("target", [50.0, 5.0, 0.5])
def test_sampling_reduce_picks_the_jax_packages_strategy(target):
    B = CASES["rand8"]
    got, want = tr.sampling_reduce(B, target), jr.sampling_reduce(B, target)
    assert got["strategy"] == want["strategy"]
    assert got["sigma_feasible"] == want["sigma_feasible"]
    np.testing.assert_array_equal(got["basis"], want["basis"])
    _close(got["max_gs"], want["max_gs"])


def test_non_integer_basis_is_rejected():
    with pytest.raises(ValueError):
        tr.lll_reduce(np.array([[1.5, 0.0], [0.0, 1.0]]))


_LOAD = """
import sys
from lattice_gaussian_mcmc_tpu_torch.reduction import build
build.BUILD_DIR = sys.argv[1]
lib = build.load_library()
print(lib is not None and build.library_path().startswith(sys.argv[1]))
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Each process compiles to a name of its own and moves the result into
    place, so neither can load a partial library."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert outs == ["True", "True"]
    assert [f for f in os.listdir(tmp_path)] == [
        os.path.basename(tbuild.library_path())]


def test_reduction_digests_are_those_of_the_jax_packages_bases():
    """`tools/reduction_digest.py`, which the smoke prints to compare
    hosts, digests the port's LLL and BKZ-20 bases of the suite's q-ary
    lattice at n = 16; they are the JAX package's bases."""
    from lattice_gaussian_mcmc_tpu.lattices import qary_lattice as jqary
    from lattice_gaussian_mcmc_tpu_torch.tools import reduction_digest as rd
    got = rd.port_digests((16,))[16]
    B = np.asarray(jqary(16, 8, q=3329, seed=42).basis)
    R = jr.lll_reduce(B)
    assert got["lll"] == rd.digest(R)
    assert got["bkz20"] == rd.digest(jr.bkz_reduce(R, beta=20, max_tours=2))
