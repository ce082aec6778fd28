"""Build the CUDA kernels at first use: nvcc -> shared library -> ctypes.

Each source in `csrc/` compiles to `_build/lib<name>-<hash>.so` inside the
package (the hash covers the source and the flags, so an edited source
rebuilds), with a plain C interface and no PyTorch headers. Builds happen
in the process that first launches a kernel, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

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


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": r.stderr[-4000:]}
    return out


def load_klein() -> ctypes.CDLL:
    """The Klein kernel library with its C signatures declared."""
    lib = _LIBS.get("klein")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("klein"))
    p, i, ll, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
    lib.klein_draw_launch.argtypes = [p, p, p, p, p, p, p, i, ll, i,
                                      u32, u32, u32, u32, p]
    lib.klein_draw_launch.restype = i
    lib.imhk_fused_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, ll, i,
                                      i, u32, u32, u32, u32, p]
    lib.imhk_fused_launch.restype = i
    lib.klein_error_string.argtypes = [i]
    lib.klein_error_string.restype = ctypes.c_char_p
    _LIBS["klein"] = lib
    return lib
