"""Rank body of the CPU-rank scaling curve (counterpart of the JAX
package's `experiments/_mesh_scaling_worker.py`, which runs the curve on a
virtual CPU device mesh). `mesh_scaling.measure_on_cpu_ranks` starts
max(W) of these through `runtime.run_ranks`; they join one gloo group on
the CPU and, for each W, the first W ranks run `mesh_scaling.scaling_rows`
on the mesh of W ranks while the others wait. Rank 0 prints the rows as
its last line.

Usage (under the LATTICE_MCMC_* variables):
    python -m lattice_gaussian_mcmc_tpu_torch.experiments._mesh_scaling_worker \
        <chains_per_device> <n_samples> <seed> <W> [<W> ...]
"""

import json
import sys


def main() -> int:
    chains_per_device, n_samples, seed = map(int, sys.argv[1:4])
    rank_counts = [int(w) for w in sys.argv[4:]]
    import torch.distributed as dist

    from lattice_gaussian_mcmc_tpu_torch.experiments.mesh_scaling import (
        scaling_rows,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import make_mesh
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        init_runtime,
        shutdown_runtime,
    )
    info = init_runtime(device="cpu")
    out = {"rows": [], "pallas_rows": [], "peikert_rows": []}
    try:
        for w in rank_counts:
            mesh = make_mesh(info.device, n_ranks=w)
            if mesh is not None:
                rows = scaling_rows(mesh, chains_per_device, n_samples, seed)
                for k in out:
                    out[k] += rows[k]
            dist.barrier()
    finally:
        shutdown_runtime()
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
