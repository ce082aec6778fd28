"""Read the SASS of the built kernel libraries (`cuobjdump -sass`), for the
measurements that need it: the instructions of B8's Philox call behind
its bound (`chip_smoke.py` `zn_bound_ms`) and a digest of each library's
code for comparing two trees (`tools/ab_klein.py`). Needs the CUDA
toolkit; no sampling path uses it.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build


def listing(library: str) -> str:
    """`cuobjdump -sass` of the shared library at path `library`."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout


def instructions(sass: str, function: str) -> int:
    """Instructions of `function` in a SASS listing, up to its first EXIT,
    NOPs left out."""
    body = sass.split(f"Function : {function}\n", 1)[1]
    count = 0
    for line in body.splitlines():
        if line.strip().startswith("Function :"):
            break
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)",
                     line)
        if m is None or m.group(1).startswith("NOP"):
            continue
        count += 1
        if m.group(1).startswith("EXIT"):
            break
    return count


def philox_instructions() -> int:
    """SASS instructions of one Philox4x32-10 call as B8 makes it: those of
    `zn.cu`'s `zn_philox_probe` less those of `zn_store_probe` (the same
    index arithmetic and 16-byte store without the call)."""
    sass = listing(_build.build("zn"))
    return (instructions(sass, "zn_philox_probe")
            - instructions(sass, "zn_store_probe"))


def digests(names) -> dict:
    """name -> the first 16 hex digits of sha256 of the built library's
    SASS, with the anonymous namespace's build-specific name replaced, so
    two trees whose kernels compile to the same code agree."""
    out = {}
    for name in names:
        sass = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+)_(\w+?)_cu_[0-9a-f]{8}",
                      r"ANON_\1_\2", listing(_build.library_path(name)))
        out[name] = hashlib.sha256(sass.encode()).hexdigest()[:16]
    return out
