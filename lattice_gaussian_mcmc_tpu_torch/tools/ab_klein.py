"""Time kernels B1 and B2 of one checkout of the port at the flagship
shapes, for comparing two trees on one card.

    python3 lattice_gaussian_mcmc_tpu_torch/tools/ab_klein.py TREE

imports `lattice_gaussian_mcmc_tpu_torch` from the checkout at TREE (it
fails if the package comes from elsewhere), builds its `csrc/klein.cu`,
and prints one JSON line: the tree, one B1 draw and one 64-step B2 launch
in ms by CUDA events (NTRU-512, sigma 165.7, window by tail budget 0.01,
524,288 chains), the accept count (equal across trees whose kernels make
the same decisions), and ptxas's register lines for the library. Run it
for parent, change, change, parent in one session on one card.
"""

from __future__ import annotations

import json
import os
import sys

CHAINS = 524288
STEPS = 64
SIGMA = 165.7


def main(tree: str) -> dict:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch
    from lattice_gaussian_mcmc_tpu_torch.lattices import ntru_lattice
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute
    if not klein_cuda.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {klein_cuda.__file__}, not {root}")
    lat = ntru_lattice(512, q=12289, seed=0,
                       cache_dir=os.path.join(root, "bench_cache"),
                       device="cuda")
    ops = klein_cuda.kernel_operands(
        klein_precompute(lat, SIGMA, tail_budget=0.01))

    def ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    y, lw = klein_cuda.klein_draw(ops, CHAINS, seed=7)   # builds, warms
    b1 = ms(lambda: klein_cuda.klein_draw(ops, CHAINS, seed=7))
    acc = torch.zeros_like(lw)
    b2 = ms(lambda: klein_cuda.imhk_fused(ops, y, lw, acc, STEPS, seed=7,
                                          step=1))
    ptxas = [ln.strip() for ln in
             _build.BUILD_INFO.get("klein", {}).get("ptxas", "").splitlines()
             if "entry function" in ln or "registers" in ln]
    return {"tree": tree, "b1_ms": b1, f"b2_{STEPS}_ms": b2,
            "accepted": float(acc.sum()), "ptxas": ptxas}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1])), flush=True)
