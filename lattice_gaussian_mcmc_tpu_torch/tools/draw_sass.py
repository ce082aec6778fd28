"""Count the SASS instructions of a row's draw in one checkout of the port,
for comparing two trees.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/draw_sass.py TREE

imports `lattice_gaussian_mcmc_tpu_torch` from the checkout at TREE (it
fails if the package comes from elsewhere), builds its `imhk_tc`,
`klein_tc` and `peikert_tc` libraries and prints one JSON line: for B2 at
windows 16 and 24, centred B1 at window 40 and B5 at window 24, the
innermost loop of the kernel that draws (`sass.draw_loop`: its
instructions and exps) and the rows it draws (its exps over those of
one row's draw); each draw function alone (`sass.draw_probes`, built from
TREE's headers: a thread's instructions and exps for one row); and B2's
registers, spill bytes and chains resident an SM at n_pad 1024 and 2048
(`klein_cuda.imhk_tc_resources`). Needs a CUDA card and the toolkit.
"""

from __future__ import annotations

import json
import os
import sys

# (library, kernel-name fragment, draw probe): the narrow, non-debug
# instantiations the cells launch
KERNELS = {
    "b2_w16": ("imhk_tc", "imhk_tc_kernelILi16ELb0ELb0E", "pair16"),
    "b2_w24": ("imhk_tc", "imhk_tc_kernelILi24ELb0ELb0E", "pair24"),
    "b1_centred_w40": ("klein_tc",
                       "klein_tc_kernelILi40ELb0ELb0ELb0ELb0ELb1E", "pair40"),
    "b5_w24": ("peikert_tc", "peikert_tc_kernelILi24ELb0ELi32E", "row24"),
}


def main(tree: str) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    if not klein_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {klein_cuda.__file__}, not {root}")
    # this tool's neighbour, on TREE's `_build`
    import sass
    libs = sorted({lib for lib, _, _ in KERNELS.values()})
    _build.build_all(libs)
    listings = {lib: sass.listing(_build.library_path(lib)) for lib in libs}
    probes = sass.draw_probes(_build.CSRC)
    res = {"tree": root, "probes": probes}
    for name, (lib, frag, probe) in KERNELS.items():
        loop = sass.draw_loop(listings[lib],
                              sass.function_name(listings[lib], frag))
        rows = loop["ex2"] / max(probes[probe]["ex2"], 1)
        loop["rows"] = rows
        loop["per_row"] = loop["instructions"] / rows if rows else None
        res[name] = loop
    res["b2_resources"] = {
        f"n_pad{n_pad}_w{w}": klein_cuda.imhk_tc_resources(n_pad, w)
        for n_pad, w in ((1024, 16), (2048, 24))}
    return res


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])), flush=True)
