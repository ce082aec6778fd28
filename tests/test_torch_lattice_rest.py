"""The rest of the port's lattice layer (q-ary constructions, Hermite
normal form, security estimates, parameter tables, the NTRU checks)
against the JAX package's on the cases of `tests/unit/test_lattices.py`,
`test_gap_features.py` and `test_ntru.py`. Integer bases must be equal;
the float64 QR of the same basis agrees to 1e-9 relative."""

import jax.numpy as jnp
import numpy as np
import pytest

from lattice_gaussian_mcmc_tpu import lattices as jl
from lattice_gaussian_mcmc_tpu.lattices import ntru as jntru
from lattice_gaussian_mcmc_tpu.lattices import qary as jq
from lattice_gaussian_mcmc_tpu_torch import lattices as tl
from lattice_gaussian_mcmc_tpu_torch.lattices import ntru as tntru
from lattice_gaussian_mcmc_tpu_torch.lattices import qary as tq

RTOL = 1e-9


def _same_lattice(t, j):
    np.testing.assert_array_equal(t.basis.numpy(), np.asarray(j.basis))
    np.testing.assert_allclose(t.gs_norms.numpy(), np.asarray(j.gs_norms),
                               rtol=RTOL)
    assert t.name == j.name and t.meta == j.meta


def test_qary_constructions_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    A, q = rng.integers(0, 17, size=(3, 4)), 17
    np.testing.assert_array_equal(tq.dual_qary_basis(A, q),
                                  jq.dual_qary_basis(A, q))
    for dual in (False, True):
        _same_lattice(tl.qary_from_matrix(A, q, dual=dual, device="cpu"),
                      jl.qary_from_matrix(A, q, dual=dual,
                                          dtype=jnp.float64))
        _same_lattice(tl.qary_lattice(8, 4, 97, seed=3, dual=dual,
                                      device="cpu"),
                      jl.qary_lattice(8, 4, 97, seed=3, dual=dual,
                                      dtype=jnp.float64))
    _same_lattice(tl.lwe_lattice(A, q, device="cpu"),
                  jl.lwe_lattice(A, q, dtype=jnp.float64))
    h = np.array([1, 2, 3, 4])
    _same_lattice(tl.rlwe_lattice(h, q=97, device="cpu"),
                  jl.rlwe_lattice(h, q=97, dtype=jnp.float64))
    hs = np.array([[1, 2], [3, 4]])
    _same_lattice(tl.module_lattice(hs, q=17, device="cpu"),
                  jl.module_lattice(hs, q=17, dtype=jnp.float64))


def test_hnf_and_volume_equal_the_jax_packages():
    rng = np.random.default_rng(7)
    for _ in range(10):
        n = int(rng.integers(2, 6))
        B = rng.integers(-9, 10, size=(n, n))
        while abs(round(np.linalg.det(B.astype(float)))) < 1:
            B = rng.integers(-9, 10, size=(n, n))
        np.testing.assert_array_equal(tl.hnf(B), jl.hnf(B))
    B = tq.qary_basis(np.random.default_rng(3).integers(0, 97, (3, 3)), 97)
    np.testing.assert_array_equal(tl.hnf(B), jl.hnf(B))
    rect = np.array([[2, 0], [0, 2], [1, 1]]).T
    np.testing.assert_array_equal(tl.hnf(rect), jl.hnf(rect))
    for n, q, k in ((6, 97, 3), (64, 3329, None)):
        assert tl.lattice_volume_qary(n, q, k) == jl.lattice_volume_qary(n, q,
                                                                          k)


def test_security_estimates_equal_the_jax_packages():
    for kw in ({"n": 1024, "q": 12289, "sigma": 4.05},
               {"n": 256, "q": 3329, "sigma": 8.0, "k": 128},
               {"n": 256, "q": 3329, "sigma": 8.0, "k": 192},
               {"n": 1024, "q": 12289, "sigma": 1.17 * np.sqrt(12289 / 2048),
                "k": 512}):
        assert tl.estimate_bkz_security(**kw) == jl.estimate_bkz_security(**kw)
    lat_t = tl.qary_lattice(256, 128, q=3329, seed=0, device="cpu")
    lat_j = jl.qary_lattice(256, 128, q=3329, seed=0, dtype=jnp.float64)
    assert tl.estimate_security_from_lattice(lat_t, 8.0) == \
        jl.estimate_security_from_lattice(lat_j, 8.0)
    # no meta: the determinant from the Gram-Schmidt profile
    got = tl.estimate_security_from_lattice(
        tl.lattice_from_basis(lat_t.basis.numpy(), device="cpu"), 8.0)
    want = jl.estimate_security_from_lattice(
        jl.lattice_from_basis(np.asarray(lat_j.basis), dtype=jnp.float64),
        8.0)
    assert got["beta"] == want["beta"]
    np.testing.assert_allclose(got["log2_det"], want["log2_det"], rtol=RTOL)
    for level in (2, 3, 5):
        assert tl.dilithium_parameters(level) == \
            jl.dilithium_parameters(level)
    for variant in (512, 1024):
        assert tl.falcon_parameters(variant) == jl.falcon_parameters(variant)
    for fn in (tl.dilithium_parameters, tl.falcon_parameters):
        with pytest.raises(ValueError):
            fn(256)


@pytest.mark.parametrize("n, ternary", [(16, False), (64, False),
                                        (16, True)])
def test_ntru_checks_equal_the_jax_packages(n, ternary):
    key = jntru.ntru_keygen(n, q=12289, seed=2 + 4 * ternary,
                            ternary=ternary)
    got, want = tl.verify_ntru_basis(key), jntru.verify_ntru_basis(key)
    assert got == want and all(got.values())
    assert tntru.ducas_prest_bound(n, 12289) == \
        jntru.ducas_prest_bound(n, 12289)
    bad = dict(key, g=np.roll(key["g"], 1))
    assert tl.verify_ntru_basis(bad) == jntru.verify_ntru_basis(bad)
