"""Digests of the reduced q-ary bases behind the benchmark suite, for
comparing them across hosts.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/reduction_digest.py [--variants]

For n = 16, 64 and 256: the first 16 hex digits of the sha256 of the
LLL-reduced `qary_lattice(n, n/2, q=3329, seed 42)` (int64, columns, as
`lll_reduce` returns it; the suite's q-ary rows at 16 and 64 sample on
it) and of its BKZ-20 (2 tours) reduction (`bench_reduction`'s), with
their seconds, on the port's library (`reduction/build.py`'s flags).
With --variants the same for copies of the library built with other code
generation (-march=x86-64, -march=haswell, and each with
-ffp-contract=off), compiled into a temporary directory. Prints one JSON
line with the host's CPU model and its FMA, AVX2 and AVX-512F flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

DIMS = (16, 64, 256)
QARY_Q, SEED = 3329, 42
VARIANTS = {"x86-64": ["-march=x86-64"], "haswell": ["-march=haswell"],
            "native_nocontract": ["-march=native", "-ffp-contract=off"],
            "x86-64_nocontract": ["-march=x86-64", "-ffp-contract=off"],
            "haswell_nocontract": ["-march=haswell", "-ffp-contract=off"]}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int64).tobytes()).hexdigest()[:16]


def qary_basis(n: int):
    from lattice_gaussian_mcmc_tpu_torch.lattices.qary import qary_lattice
    return qary_lattice(n, n // 2, q=QARY_Q, seed=SEED,
                        device="cpu").basis.numpy()


def port_digests(dims=DIMS) -> dict:
    """{n: {lll, bkz20, lll_s, bkz20_s}} on the port's library."""
    from lattice_gaussian_mcmc_tpu_torch.reduction import (
        bkz_reduce,
        lll_reduce,
    )
    out = {}
    for n in dims:
        t0 = time.perf_counter()
        R = lll_reduce(qary_basis(n))
        t1 = time.perf_counter()
        K = bkz_reduce(R, beta=20, max_tours=2)
        t2 = time.perf_counter()
        out[n] = {"lll": digest(R), "bkz20": digest(K), "lll_s": t1 - t0,
                  "bkz20_s": t2 - t1}
    return out


def variant_digests(flags, dims=DIMS) -> dict:
    """The same on a copy of the library built with `flags` (rows
    convention inside, as `lll.py` calls it)."""
    import numpy as np
    from lattice_gaussian_mcmc_tpu_torch.reduction.build import SRC
    i64p = ctypes.POINTER(ctypes.c_int64)
    with tempfile.TemporaryDirectory() as d:
        so = os.path.join(d, "lib.so")
        subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", "-o", so,
                        SRC], check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(so)
        lib.lll_reduce.argtypes = [i64p, ctypes.c_int, ctypes.c_double]
        lib.bkz_reduce.argtypes = [i64p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_int]
        out = {}
        for n in dims:
            rows = np.ascontiguousarray(
                np.round(qary_basis(n)).astype(np.int64).T)
            t0 = time.perf_counter()
            lib.lll_reduce(rows.ctypes.data_as(i64p), n, 0.99)
            t1 = time.perf_counter()
            lll = digest(rows.T)
            lib.bkz_reduce(rows.ctypes.data_as(i64p), n, 20, 0.99, 2)
            t2 = time.perf_counter()
            out[n] = {"lll": lll, "bkz20": digest(rows.T), "lll_s": t1 - t0,
                      "bkz20_s": t2 - t1}
    return out


def host() -> dict:
    model, flags = "unknown", set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") and model == "unknown":
                    model = line.split(":", 1)[1].strip()
                if line.startswith("flags") and not flags:
                    flags = set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return {"cpu": model, **{k: k in flags
                             for k in ("fma", "avx2", "avx512f")}}


def main(variants: bool = False) -> dict:
    sys.path.insert(0, _ROOT)
    from lattice_gaussian_mcmc_tpu_torch.reduction.build import FLAGS
    out = {"host": host(), "port": {"flags": FLAGS, **port_digests()}}
    if variants:
        for name, flags in VARIANTS.items():
            out[name] = variant_digests(flags)
    return out


if __name__ == "__main__":
    print(json.dumps(main("--variants" in sys.argv[1:])))
