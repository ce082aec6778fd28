"""Count the SASS instructions of a row's draw in one checkout of the port,
for comparing two trees.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/draw_sass.py TREE [WINDOW]

imports `lattice_gaussian_mcmc_tpu_torch` from the checkout at TREE (it
fails if the package comes from elsewhere), builds its `imhk_tc`,
`klein_tc`, `smk_tc` and `peikert_tc` libraries and prints one JSON line:
for B2 at windows 16 and 24, B1 at 16, centred B1 at 40 and B5 at 24,
the innermost loop of the kernel that draws (`sass.draw_loop`: its
instructions and exps) and the rows it draws (its exps over those of
one row's draw); each draw function alone (`sass.draw_probes`, built from
TREE's headers: a thread's instructions and exps for one row); for the
runtime-window (W 0) instantiations of B2 and B1, narrow and WIDE, their
loop over rows at WINDOW (default 88, the q-ary cell's) with each segment
loop counted once a segment of a side (`sass.runtime_draw_loop`: the
shortest and the longest path a row); a digest of every function of the
four libraries (`sass.function_digest`), so that two trees' compiled
instantiations can be seen to be the same code; B2's registers, spill
bytes and chains resident an SM at n_pad 1024 and 2048
(`klein_cuda.imhk_tc_resources`); and at WINDOW, B2's and B1's, narrow
and WIDE, at n_pad 128 and 1024. Needs a CUDA card and the toolkit.
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
    "b1_w16": ("klein_tc", "klein_tc_kernelILi16ELb0ELb0ELb0ELb0ELb0E",
               "pair16"),
    "b1_centred_w40": ("klein_tc",
                       "klein_tc_kernelILi40ELb0ELb0ELb0ELb0ELb1E", "pair40"),
    "b5_w24": ("peikert_tc", "peikert_tc_kernelILi24ELb0ELi32E", "row24"),
}
# (library, kernel-name fragment, the compiled instantiation whose row loop
# draws as many rows): the runtime-window instantiations
RUNTIME = {
    "b2_w0": ("imhk_tc", "imhk_tc_kernelILi0ELb0ELb0E", "b2_w16"),
    "b2_wide_w0": ("imhk_tc", "imhk_tc_kernelILi0ELb0ELb1E", "b2_w16"),
    "b1_w0": ("klein_tc", "klein_tc_kernelILi0ELb0ELb0ELb0ELb0ELb0E",
              "b1_w16"),
    "b1_wide_w0": ("klein_tc", "klein_tc_kernelILi0ELb0ELb0ELb0ELb1ELb0E",
                   "b1_w16"),
}
LIBS = ("imhk_tc", "klein_tc", "smk_tc", "peikert_tc")


def main(tree: str, window: int = 88) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    if not klein_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {klein_cuda.__file__}, not {root}")
    # this tool's neighbour, on TREE's `_build`
    import sass
    _build.build_all(list(LIBS))
    listings = {lib: sass.listing(_build.library_path(lib)) for lib in LIBS}
    probes = sass.draw_probes(_build.CSRC)
    res = {"tree": root, "window": window, "probes": probes}
    for name, (lib, frag, probe) in KERNELS.items():
        loop = sass.draw_loop(listings[lib],
                              sass.function_name(listings[lib], frag))
        rows = loop["ex2"] / max(probes[probe]["ex2"], 1)
        loop["rows"] = rows
        loop["per_row"] = loop["instructions"] / rows if rows else None
        res[name] = loop
    trips = -(-(window - window // 2) // 8)
    for name, (lib, frag, like) in RUNTIME.items():
        res[name] = sass.runtime_draw_loop(
            listings[lib], sass.function_name(listings[lib], frag), trips,
            res[like]["rows"])
    res["digests"] = {lib: {sass.stable_name(fn):
                            sass.function_digest(listings[lib], fn)
                            for fn in sass.functions(listings[lib])}
                      for lib in LIBS}
    res["b2_resources"] = {
        f"n_pad{n_pad}_w{w}": klein_cuda.imhk_tc_resources(n_pad, w)
        for n_pad, w in ((1024, 16), (2048, 24))}
    res["w0_resources"] = {
        f"{k}_n_pad{n_pad}": res_of(n_pad)
        for n_pad in (128, 1024)
        for k, res_of in (
            ("b2", lambda n: klein_cuda.imhk_tc_resources(n, window)),
            ("b2_wide",
             lambda n: klein_cuda.imhk_tc_resources(n, window, wide=True)),
            ("b1", lambda n: klein_cuda.klein_tc_resources(n, window)),
            ("b1_wide",
             lambda n: klein_cuda.klein_tc_resources(n, window, "b1_wide")))}
    return res


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], *map(int, sys.argv[2:3]))),
          flush=True)
