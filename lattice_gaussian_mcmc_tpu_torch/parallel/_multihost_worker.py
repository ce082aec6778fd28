"""Rank body of the multi-process checks (counterpart of the JAX package's
`parallel/_multihost_worker.py`).

Each rank joins the process group from the LATTICE_MCMC_* variables
(`runtime.run_ranks` sets them), runs the sharded paths on its chain range
and gathers their outputs; the primary writes the digests (with the
rank's kernel launches) to `--out`, and every rank prints them as its last
line. A run at world size 1 (or the
unsharded routes) must give the same digests: the Philox stream is keyed
by global chain id.

Problems:
  small  the JAX worker's: n = 6, an upper-triangular integer basis with
         3 on the diagonal, sigma 4.0; `sharded_imhk_chains` (5 samples,
         burn-in 2), `sharded_imhk_blocked` and `sharded_peikert`
         (sigma 3 s1(B)) on the CPU or a card
  ntru   the flagship: the NTRU-512 key of seed 0 (dimension 1024) read
         from --cache-dir, sigma 165.7 with tail budget 0.01 (B1 + B2),
         Peikert at 1.05 r s1(B) (B5)

Usage:
    python -m lattice_gaussian_mcmc_tpu_torch.parallel._multihost_worker \
        --device cpu --out digests.json [--problem ntru --cache-dir DIR \
        --chains 65536 --steps 64 --rounds 2]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

FALCON_SIGMA = 165.7
PEIKERT_SIGMA_OVER_RS1 = 1.05


def problem(name: str, device, cache_dir: str = "bench_cache"):
    """(lattice, Klein sigma, Klein tail budget, Peikert sigma) of a
    problem."""
    from lattice_gaussian_mcmc_tpu_torch.lattices import (
        lattice_from_basis,
        ntru_lattice,
    )
    from lattice_gaussian_mcmc_tpu_torch.ops.theta import (
        smoothing_parameter_zn,
    )
    if name == "small":
        rng = np.random.default_rng(0)
        n = 6
        basis = np.triu(rng.integers(-2, 3, (n, n))).astype(np.float64)
        np.fill_diagonal(basis, 3.0)
        lat = lattice_from_basis(basis, device=device)
        return lat, 4.0, None, 3.0 * float(np.linalg.norm(basis, 2))
    if name == "ntru":
        lat = ntru_lattice(512, q=12289, seed=0, cache_dir=cache_dir,
                           device=device)
        s1 = float(np.linalg.norm(lat.basis.cpu().double().numpy(), 2))
        r = smoothing_parameter_zn(lat.n, 0.01)
        return lat, FALCON_SIGMA, 0.01, PEIKERT_SIGMA_OVER_RS1 * r * s1
    raise ValueError(f"unknown problem {name!r}")


def digest(mesh, *tensors) -> str:
    """sha256 of the gathered (all ranks', in chain order) bytes of each
    tensor in turn."""
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        all_processes_array,
    )
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(all_processes_array(t, mesh))
                 .tobytes())
    return h.hexdigest()


def run_paths(mesh, name: str, n_chains: int, n_steps: int, n_rounds: int,
              imhk_samples: int = 0, cache_dir: str = "bench_cache"
              ) -> dict:
    """The sharded paths of problem `name` on `mesh`: digests of their
    gathered outputs and their pooled diagnostics."""
    from lattice_gaussian_mcmc_tpu_torch.ops.kernels.peikert_cuda import (
        peikert_operands,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel.collectives import (
        sharded_imhk_blocked,
        sharded_imhk_chains,
        sharded_peikert,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        klein_precompute,
        peikert_precompute,
    )
    lat, sigma, budget, sigma_pk = problem(name, mesh.device, cache_dir)
    pre = klein_precompute(lat, sigma, tail_budget=budget)
    out = {}
    if imhk_samples:
        coeffs, log_ws, stats = sharded_imhk_chains(
            pre, n_chains, imhk_samples, mesh, thin=1, burn_in=2)
        out["imhk_chains"] = {"digest": digest(mesh, coeffs, log_ws),
                              "acceptance": stats["acceptance_rate"]}
    X, lw, acc, rate = sharded_imhk_blocked(pre, n_chains, n_steps, mesh,
                                            seed=1)
    out["blocked"] = {"digest": digest(mesh, X, lw, acc), "acceptance": rate}
    del X, lw, acc
    ops = peikert_operands(peikert_precompute(lat, sigma_pk))
    Xp, _, var = sharded_peikert(ops, n_chains, mesh, n_rounds, seed=2)
    out["peikert"] = {"digest": digest(mesh, Xp),
                      "pooled_var_max": float(var.max())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--problem", default="small", choices=("small", "ntru"))
    p.add_argument("--cache-dir", default="bench_cache")
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--imhk-samples", type=int, default=5)
    args = p.parse_args(argv)

    from lattice_gaussian_mcmc_tpu_torch.ops.kernels import launch_record
    from lattice_gaussian_mcmc_tpu_torch.parallel.runtime import (
        global_mesh,
        init_runtime,
        shutdown_runtime,
    )
    info = init_runtime(device=args.device)
    try:
        result = run_paths(global_mesh(info.device), args.problem,
                           args.chains, args.steps, args.rounds,
                           args.imhk_samples, args.cache_dir)
        rec = launch_record.read()
        result.update(process_count=info.process_count,
                      process_index=info.process_index,
                      distributed=info.distributed, backend=info.backend,
                      device=str(info.device), launches={
                          k: rec[k]["launches"] for k in (
                              "klein_draw", "imhk_fused", "peikert_rounds")})
    finally:
        shutdown_runtime()
    if info.process_index == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
