"""Build the CUDA kernels at first use: nvcc -> shared library -> ctypes.

Each source in `csrc/` compiles to `_build/lib<name>-<hash>.so` inside the
package (the hash covers the source, the shared headers `csrc/*.cuh` and
the flags, so an edited source rebuilds), with a plain C interface and no
PyTorch headers. Builds happen in the process that first launches a
kernel, never at import. `edited_sources` and `load(name, csrc)` build a
deliberately changed copy of a source beside the real one, for the tools
that check or time such copies (`smoke_mutants.py`,
`tools/imhk_split.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
# name -> {"seconds": build time, "ptxas": compiler report}; empty until
# a build ran in this process
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str, csrc: str = CSRC) -> str:
    """The library's path; its hash covers the source, the shared headers
    of the source directory and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(csrc, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, csrc: str = CSRC) -> str:
    """Compile <csrc>/<name>.cu unless its library exists; return its
    path."""
    build_all((name,), csrc)
    return library_path(name, csrc)


def edited_sources(dest: str, fname: str, edits) -> str:
    """Copy csrc/ to `dest` and make the (old, new) `edits` in its file
    `fname`, each old string found there exactly once; return `dest`."""
    shutil.copytree(CSRC, dest, dirs_exist_ok=True)
    path = os.path.join(dest, fname)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit site not found once in {fname}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return dest


_P, _I, _LL, _U32, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32, ctypes.c_float)
# name -> {C function: argument types}; every function returns int except
# the error-string one
_SIGNATURES = {
    "klein": {
        "klein_ring_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                              _U32, _U32, _U32, _U32, _P],
        "babai_decode_launch": [_P, _P, _P, _P, _P, _I, _LL, _P],
    },
    "klein_tc": {
        "klein_tc_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I,
                            _I, _U32, _U32, _U32, _U32, _I, _P],
        "babai_tc_launch": [_P, _P, _P, _P, _P, _I, _LL, _P],
        "klein_tc_info": [_I, _I, _I, _P],
        "klein_tc_centred_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL,
                                    _I, _U32, _U32, _U32, _U32, _P],
    },
    "imhk_tc": {
        "imhk_tc_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _LL, _I, _I, _U32, _U32, _U32,
                           _U32, _P],
        "imhk_tc_info": [_I, _I, _I, _P],
    },
    "smk_tc": {
        "smk_tc_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _LL, _I, _I, _U32, _U32, _U32, _U32, _P],
        "smk_tc_info": [_I, _I, _P],
    },
    "peikert_tc": {
        "peikert_tc_launch": [_P, _P, _F, _P, _P, _P, _P, _I, _LL, _I, _I,
                              _I, _U32, _U32, _U32, _P],
    },
    "zn": {
        "zn_draw_launch": [_F, _F, _I, _P, _P, _LL, _U32, _U32, _P],
    },
    "sign": {
        "hash_to_point_launch": [_P, _LL, _I, _U32, _U32, _U32, _P],
        "redraw_uniforms_launch": [_P, _P, _LL, _I, _U32, _U32, _U32, _P],
    },
    "points": {
        "points_launch": [_P, _I, _I, _LL, _LL, _LL, _I, _I, _P, _I, _P, _P,
                          _P],
    },
}


def load(name: str, csrc: str = CSRC) -> ctypes.CDLL:
    """The kernel library <csrc>/<name>.cu (csrc/ of the package unless
    given), built at first use, with its C signatures declared."""
    lib = _LIBS.get((name, csrc))
    if lib is not None:
        return lib
    with span("lgm.setup.build"):
        lib = ctypes.CDLL(build(name, csrc))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [_I]
    err.restype = ctypes.c_char_p
    _LIBS[(name, csrc)] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name, t, shape, dtype=None):
    """Raise unless t is a contiguous CUDA tensor of `shape` and `dtype`
    (float32 by default)."""
    dtype = torch.float32 if dtype is None else dtype
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(name: str, rc: int, what: str):
    """Raise if a launch of library `name` returned CUDA error `rc`."""
    if rc:
        msg = getattr(load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def build_all(names=tuple(_SIGNATURES), csrc: str = CSRC) -> dict:
    """Compile the named libraries at once, one nvcc process per source, all
    started together; returns {name: seconds} for those built here."""
    todo = [n for n in names if not os.path.exists(library_path(n, csrc))]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = f"{library_path(n, csrc)}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(csrc, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{err[-4000:]}")
            continue
        os.replace(tmp, library_path(n, csrc))
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0,
                         "ptxas": err[-4000:]}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: BUILD_INFO[n]["seconds"] for n in procs}
