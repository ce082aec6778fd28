"""Build of the native reduction library at first use (g++ -O3 -shared).

`cpp/lattice_reduce.cpp` compiles to `_build/liblattice_reduce-<hash>.so`
inside the package; the hash covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. The compiler writes
to a name of its own process and the result is moved into place with
`os.replace`, so processes that build at once (test workers) each load a
whole library. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "cpp", "lattice_reduce.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"liblattice_reduce-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; return its path."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
        try:
            subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once, if needed) and dlopen the reduction library. Returns
    None if it cannot be built (no compiler): callers then take the
    pure-Python LLL, as the JAX package does."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, subprocess.SubprocessError):
            return None
        i64p, dblp = (ctypes.POINTER(ctypes.c_int64),
                      ctypes.POINTER(ctypes.c_double))
        lib.lll_reduce.argtypes = [i64p, ctypes.c_int, ctypes.c_double]
        lib.lll_reduce.restype = ctypes.c_int
        lib.bkz_reduce.argtypes = [i64p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_int]
        lib.bkz_reduce.restype = ctypes.c_int
        lib.gso_profile.argtypes = [i64p, ctypes.c_int, dblp]
        lib.gso_profile.restype = ctypes.c_int
        _lib = lib
        return _lib
