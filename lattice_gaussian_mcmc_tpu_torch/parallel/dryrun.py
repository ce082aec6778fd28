"""Multi-rank dry run (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): the sharded paths with their
collective diagnostics, at tiny shapes, across n ranks.

On the n = 8 random integer basis of the reference at the hard sigma
0.8 min ||b*_i|| (acceptance well below 1), each rank checks:
  * `sharded_imhk_chains` (16 chains, 8 samples, burn-in 1): pooled
    acceptance in (0.02, 0.97) and a finite R-hat of the coefficient sum
    from `global_gelman_rubin`;
  * the kernel path `sharded_imhk_blocked` (256 chains a rank, 2 steps;
    B1 + B2 on a card): acceptance in (0, 1] and finite log-weights;
  * `sharded_peikert` (256 chains a rank, one round, window 16, sigma
    3 s1(B); B5 on a card): finite, positive pooled variance.
The reference's record is `MULTICHIP_r05.json` (8 CPU devices, acceptance
0.521, R-hat 1.000); its PRNG differs, so agreement is in law.

    python -m lattice_gaussian_mcmc_tpu_torch.parallel.dryrun N [DEVICE]

runs N ranks (gloo; on a card, every rank on CUDA tensors) and prints
the primary's result.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np

IMHK_CHAINS = 16
IMHK_SAMPLES = 8
KERNEL_CHAINS_PER_RANK = 256
KERNEL_STEPS = 2
PEIKERT_ROUNDS = 1


def hard_problem(device):
    """The reference's n = 8 random integer basis on `device`: its Klein
    precomputation at the hard sigma 0.8 min ||b*_i|| and its Peikert
    operands at sigma 3 s1(B), window 16."""
    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
        peikert_operands,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        klein_precompute,
        peikert_precompute,
    )
    rng = np.random.default_rng(0)
    n = 8
    basis = rng.integers(-3, 4, size=(n, n)).astype(np.float64)
    while abs(np.linalg.det(basis)) < 1:
        basis = rng.integers(-3, 4, size=(n, n)).astype(np.float64)
    lat = lattice_from_basis(basis, device=device)
    s1 = float(np.linalg.norm(basis, 2))
    return (klein_precompute(lat, 0.8 * float(lat.gs_norms.min())),
            peikert_operands(peikert_precompute(lat, 3.0 * s1), window=16))


def dryrun_rank(mesh) -> dict:
    """The dry run's checks on this rank of `mesh`; raises on a failed
    check. Returns the pooled diagnostics."""
    import torch

    from lattice_gaussian_mcmc_tpu_torch.parallel.collectives import (
        global_gelman_rubin,
        sharded_imhk_blocked,
        sharded_imhk_chains,
        sharded_peikert,
    )
    pre, ops = hard_problem(mesh.device)
    n = ops.n

    coeffs, _, stats = sharded_imhk_chains(pre, IMHK_CHAINS, IMHK_SAMPLES,
                                           mesh, thin=1, burn_in=1)
    if tuple(coeffs.shape) != (IMHK_CHAINS // mesh.size, IMHK_SAMPLES, n):
        raise RuntimeError(f"sharded_imhk_chains shape {coeffs.shape}")
    acc = stats["acceptance_rate"]
    if not 0.02 < acc < 0.97:
        raise RuntimeError("hard-regime dry run expected mixed accept/"
                           f"reject, got acceptance {acc}")
    # R-hat of the coefficient sum: one coordinate can be (nearly)
    # deterministic at the hard sigma, with a within-chain variance of 0
    rhat = global_gelman_rubin(coeffs.sum(-1), mesh)
    if not math.isfinite(rhat):
        raise RuntimeError(f"R-hat {rhat} is not finite")

    n_kernel = KERNEL_CHAINS_PER_RANK * mesh.size
    X, lw, _, acc_k = sharded_imhk_blocked(pre, n_kernel, KERNEL_STEPS,
                                           mesh, seed=1)
    if tuple(X.shape) != (KERNEL_CHAINS_PER_RANK, n):
        raise RuntimeError(f"sharded_imhk_blocked shape {X.shape}")
    if not (0.0 < acc_k <= 1.0 and bool(torch.isfinite(lw).all())):
        raise RuntimeError(f"kernel path acceptance {acc_k} or its "
                           "log-weights out of range")

    Xp, _, var = sharded_peikert(ops, n_kernel, mesh, PEIKERT_ROUNDS,
                                 seed=2)
    if tuple(Xp.shape) != (KERNEL_CHAINS_PER_RANK * PEIKERT_ROUNDS, n):
        raise RuntimeError(f"sharded_peikert shape {Xp.shape}")
    var_max = float(var.max())
    if not (bool(torch.isfinite(var).all()) and var_max > 0.0):
        raise RuntimeError(f"Peikert pooled variance {var_max}")
    return {"n_ranks": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "acceptance": acc, "rhat": rhat,
            "kernel_acceptance": acc_k, "peikert_var_max": var_max}


def dryrun_multichip(n_ranks: int, device=None, timeout: float = 300.0
                     ) -> dict:
    """Run the dry run on n_ranks processes (`runtime.run_ranks`, at most
    `timeout` seconds) on `device` (None: the card); returns the primary's
    result. Raises if a rank's check fails."""
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import run_ranks
    from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    results = run_ranks("lattice_gaussian_mcmc_tpu_torch.parallel.dryrun",
                        n_ranks, [device.type], timeout=timeout)
    return results[0]


def main(argv) -> int:
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        global_mesh,
        init_runtime,
        shutdown_runtime,
    )
    if argv and argv[0].isdigit():       # the launcher's form: N [DEVICE]
        out = dryrun_multichip(int(argv[0]), argv[1] if len(argv) > 1
                               else None)
        print(f"dryrun_multichip({argv[0]}): ok {json.dumps(out)}")
        return 0
    info = init_runtime(device=argv[0] if argv else None)
    try:
        out = dryrun_rank(global_mesh(info.device))
    finally:
        shutdown_runtime()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
