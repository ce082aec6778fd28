"""Rank body of the process-spanning scaling rows (counterpart of the JAX
package's `experiments/_process_scaling_worker.py`): N gloo CPU processes,
one rank each, run `sharded_imhk_chains` on the JAX worker's problem
(n = 16, unit upper triangle with entries in [-0.5, 0.5), sigma 1.2) with
the chains a process fixed, a warm-up and a timed run; each prints the
row as its last line.

Usage (under the LATTICE_MCMC_* variables):
    python -m lattice_gaussian_mcmc_tpu_torch.experiments._process_scaling_worker \
        <chains_per_device> <n_samples>
"""

import json
import sys
import time

import numpy as np


def main() -> int:
    chains_per_device, n_samples = map(int, sys.argv[1:3])
    import torch

    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.parallel.collectives import (
        sharded_imhk_chains,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import all_reduce_sum
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        global_mesh,
        init_runtime,
        shutdown_runtime,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import klein_precompute

    info = init_runtime(device="cpu")
    try:
        mesh = global_mesh(info.device)
        rng = np.random.default_rng(0)
        n = 16
        basis = np.triu(rng.uniform(-0.5, 0.5, (n, n)))
        np.fill_diagonal(basis, 1.0)
        lat = lattice_from_basis(basis, dtype=torch.float32,
                                 device=info.device)
        pre = klein_precompute(lat, 1.2)
        n_chains = chains_per_device * mesh.size
        sharded_imhk_chains(pre, n_chains, n_samples, mesh)     # warm-up
        all_reduce_sum(torch.zeros(1), mesh)
        t0 = time.perf_counter()
        out = sharded_imhk_chains(pre, n_chains, n_samples, mesh, seed=1)
        all_reduce_sum(torch.zeros(1), mesh)
        dt = time.perf_counter() - t0
    finally:
        shutdown_runtime()
    print(json.dumps({
        "process_count": info.process_count,
        "n_global_devices": info.n_global_devices,
        "n_chains": n_chains,
        "samples_per_sec": n_chains * n_samples / dt,
        "acceptance": out[2]["acceptance_rate"],
        "distributed": info.distributed,
        "backend": info.backend,
        "device": "cpu",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
