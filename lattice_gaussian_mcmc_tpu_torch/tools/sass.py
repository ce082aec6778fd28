"""Read the SASS of the built kernel libraries (`cuobjdump -sass`), for the
measurements that need it: the instructions of B8's Philox call behind
its bound (`chip_smoke.py` `zn_bound_ms`), a digest of each library's
code for comparing two trees (`tools/ab_klein.py`), and the instructions
of a row's draw (`tools/draw_sass.py`): a kernel's innermost loop that
draws, and the draw functions alone in a probe. Needs the CUDA toolkit;
no sampling path uses it.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import tempfile

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


def function_name(sass: str, fragment: str) -> str:
    """The one function of a SASS listing whose (mangled) name holds
    `fragment`."""
    names = [ln.split("Function : ", 1)[1].strip()
             for ln in sass.splitlines() if "Function : " in ln]
    hits = [n for n in names if fragment in n]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} functions hold {fragment!r}")
    return hits[0]


_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][^;]*);")


def _body(sass: str, function: str):
    """[(address, instruction text)] of `function`, NOPs left out, and
    {label: address} of its branch targets."""
    body = sass.split(f"Function : {function}\n", 1)[1]
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        if line.strip().startswith("Function :"):
            break
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.match(line)
        if m is None:
            continue
        addr = int(m.group(1), 16)
        for lb in pending:
            labels[lb] = addr
        pending = []
        if not m.group(2).startswith("NOP"):
            insns.append((addr, m.group(2)))
    return insns, labels


def draw_loop(sass: str, function: str) -> dict:
    """The smallest loop of `function` (a backward branch and its target)
    that holds an exp (MUFU.EX2): its instructions and exps, NOPs left
    out. In the draw kernels that is the loop over a sub-block's rows;
    the instructions a row are its instructions over the rows it draws."""
    insns, labels = _body(sass, function)
    best = None
    for addr, text in insns:
        m = re.match(r"BRA(?:\.\S+)?\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if m is None:
            continue
        tgt = m.group(1)
        tgt = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
        if tgt is None or tgt >= addr:
            continue
        loop = [t for a, t in insns if tgt <= a <= addr]
        ex2 = sum(t.startswith("MUFU.EX2") for t in loop)
        if ex2 and (best is None or len(loop) < best["instructions"]):
            best = {"instructions": len(loop), "ex2": ex2}
    return best or {"instructions": 0, "ex2": 0}


PROBE = r"""
#include "imhk_tc_common.cuh"
using namespace lgk;
template <int W, bool PAIR>
__global__ void probe(const float* in, float* out, int window) {
  const int t = threadIdx.x;
  float logz;
  const float y = PAIR ? draw_pair<W>(in[t], in[t + 64], in[t + 128], window,
                                      t & 1, t & 31, logz)
                       : draw_row<W>(in[t], in[t + 64], in[t + 128], window,
                                     logz);
  out[t] = y;
  out[t + 64] = logz;
}
__global__ void probe_store(const float* in, float* out, int window) {
  const int t = threadIdx.x;
  out[t] = __fadd_rn(in[t], in[t + 64]);
  out[t + 64] = __fadd_rn(in[t + 128], (float)window);
}
template __global__ void probe<16, true>(const float*, float*, int);
template __global__ void probe<24, true>(const float*, float*, int);
template __global__ void probe<40, true>(const float*, float*, int);
template __global__ void probe<24, false>(const float*, float*, int);
"""

PROBES = {"pair16": "probeILi16ELb1E", "pair24": "probeILi24ELb1E",
          "pair40": "probeILi40ELb1E", "row24": "probeILi24ELb0E"}


def draw_probes(csrc: str) -> dict:
    """A thread's SASS instructions and exps (MUFU.EX2) for one row's draw,
    `draw_pair` at windows 16, 24 and 40 and `draw_row` at 24, compiled
    from the headers in `csrc` with the kernels' flags, each less a probe
    that only loads the row's operands and stores two results."""
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-I", csrc, "-o", cubin, src], check=True,
                       capture_output=True, text=True)
        sass = listing(cubin)
    base = len(_body(sass, function_name(sass, "probe_store"))[0])
    out = {}
    for name, frag in PROBES.items():
        insns, _ = _body(sass, function_name(sass, frag))
        out[name] = {"instructions": len(insns) - base,
                     "ex2": sum(t.startswith("MUFU.EX2") for _, t in insns)}
    return out


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
