"""Experiment runner CLI of the port (counterpart of the JAX package's
`experiments/cli.py`; console script `lattice-mcmc-torch`).

Usage:
    python -m lattice_gaussian_mcmc_tpu_torch.experiments.cli \
        --experiments scaling crypto --output-dir results --quick [--cpu]

Every experiment runs in-process on the CUDA card; `--cpu` passes
`device="cpu"` to every driver, which then runs the kernels' plain
versions. Without `--cpu` and with no card, each experiment fails with
`utils/device.resolve_device`'s error: there is no fallback. `mesh`
(`experiments/mesh_scaling.py`) measures its card rows at world size 1
under NCCL and the reference's curve on 1, 2, 4 and 8 gloo CPU ranks;
with `--cpu` every rank is a CPU rank.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, List

import numpy as np

EXPERIMENTS = ("convergence", "scaling", "crypto", "sensitivity",
               "validation", "benchmark", "mesh", "decoding", "adaptation")


def run_experiment(name: str, output_dir: str, quick: bool, cpu: bool) -> Dict:
    from lattice_gaussian_mcmc_tpu_torch.utils.logging import (
        get_logger,
        log_phase,
    )
    t0 = time.perf_counter()
    log = get_logger("experiments")
    with log_phase(name, log):
        out = _dispatch(name, output_dir, quick, "cpu" if cpu else None)
    return {"experiment": name, "seconds": time.perf_counter() - t0,
            "results": out}


def _dispatch(name: str, output_dir: str, quick: bool, device=None):
    """Run experiment `name` on `device` (None: the card) with the JAX
    package's configs: its defaults, or with `quick` its small budgets."""
    if name == "convergence":
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            ConvergenceConfig,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.convergence_study import run_study  # noqa: E501
        cfg = ConvergenceConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = ConvergenceConfig(
                output_dir=cfg.output_dir, dimensions=(2, 4),
                n_samples=5_000, n_chains=4, burn_in=100,
                tvd_checkpoints=(10, 100, 1000))
        out = run_study(cfg, device=device)
    elif name == "scaling":
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            ScalingConfig,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.dimension_scaling import run_scaling  # noqa: E501
        cfg = ScalingConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = ScalingConfig(output_dir=cfg.output_dir,
                                dimensions=(16, 32), n_samples=2_000,
                                n_chains_grid=(256, 1024),
                                asymptotic_dims=(32, 64))
        out = run_scaling(cfg, device=device)
    elif name == "crypto":
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            CryptoConfig,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.cryptographic import (
            run_crypto_suite,
            sigma_sensitivity,
        )
        cfg = CryptoConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = CryptoConfig(output_dir=cfg.output_dir, ntru_n=(32,),
                               qary_dims=(32,), n_samples=2_000,
                               n_chains=256)
        out = {"suite": run_crypto_suite(cfg, device=device),
               "sigma_sensitivity": sigma_sensitivity(cfg, device=device)}
    elif name == "sensitivity":
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            SensitivityConfig,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.parameter_sensitivity import run_sensitivity  # noqa: E501
        cfg = SensitivityConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = SensitivityConfig(output_dir=cfg.output_dir, dimension=8,
                                    sweep_dimensions=(4, 8),
                                    sigma_grid_size=7, n_samples=3_000)
        out = run_sensitivity(cfg, device=device)
    elif name == "validation":
        from lattice_gaussian_mcmc_tpu_torch.experiments.klein_validation import run_suite  # noqa: E501
        out = run_suite(output_dir=os.path.join(output_dir, name),
                        quick=quick, device=device)
    elif name == "mesh":
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            ExperimentConfig,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.mesh_scaling import run_mesh_scaling  # noqa: E501
        out = run_mesh_scaling(ExperimentConfig(
            output_dir=os.path.join(output_dir, name)), device=device)
    elif name == "benchmark":
        from lattice_gaussian_mcmc_tpu_torch.experiments.benchmark import (
            run_benchmarks,
        )
        from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
            BenchmarkConfig,
        )
        cfg = BenchmarkConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            # the JAX quick config's n_samples is not a field here: the
            # suite never read it
            cfg = BenchmarkConfig(output_dir=cfg.output_dir,
                                  dimensions=(16, 64), n_chains=512,
                                  timed_runs=2)
        out = run_benchmarks(cfg, device=device)
    elif name == "decoding":
        from lattice_gaussian_mcmc_tpu_torch.experiments.decoding import (
            DecodingConfig,
            run_decoding,
        )
        cfg = DecodingConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = DecodingConfig(output_dir=cfg.output_dir,
                                 dimensions=(16, 32), n_targets=24,
                                 rho_grid=(0.05, 0.3, 0.5),
                                 gibbs_sweeps=24, gibbs_chains=12,
                                 mhk_steps=64)
        out = run_decoding(cfg, device=device)
    elif name == "adaptation":
        from lattice_gaussian_mcmc_tpu_torch.experiments.adaptation import (
            AdaptationConfig,
            run_adaptation,
        )
        cfg = AdaptationConfig(output_dir=os.path.join(output_dir, name))
        if quick:
            cfg = AdaptationConfig(output_dir=cfg.output_dir, ntru_n=16,
                                   n_chains=512, n_windows=8,
                                   window_steps=4)
        out = run_adaptation(cfg, device=device)
    else:
        raise ValueError(f"unknown experiment {name!r}")
    return out


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="lattice-mcmc-torch",
        description="Lattice Gaussian MCMC experiment runner (PyTorch/CUDA)")
    p.add_argument("--experiments", nargs="+", choices=EXPERIMENTS + ("all",),
                   default=["all"])
    p.add_argument("--output-dir", default="results")
    p.add_argument("--quick", action="store_true",
                   help="small budgets for smoke runs")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)

    names = (list(EXPERIMENTS) if "all" in args.experiments
             else args.experiments)
    os.makedirs(args.output_dir, exist_ok=True)
    from lattice_gaussian_mcmc_tpu_torch.utils.logging import (
        add_run_file_handler,
        get_logger,
    )
    log_path = add_run_file_handler(os.path.join(args.output_dir, "logs"))
    print(f"[lattice-mcmc-torch] logging to {log_path}", flush=True)
    summary = []
    try:
        for name in names:
            print(f"[lattice-mcmc-torch] running {name} ...", flush=True)
            try:
                r = run_experiment(name, args.output_dir, args.quick,
                                   args.cpu)
                # an experiment that ran but failed its statistical gates
                # fails the run
                gates = _gates_passed(r["results"])
                summary.append({"experiment": name, "ok": gates is not False,
                                "gates_passed": gates,
                                "seconds": r["seconds"]})
                status = "done" if gates is not False else "GATES FAILED"
                print(f"[lattice-mcmc-torch] {name} {status} in "
                      f"{r['seconds']:.1f}s")
            except Exception as e:  # record it and run the next experiment
                import traceback
                traceback.print_exc()
                summary.append({"experiment": name, "ok": False,
                                "gates_passed": None, "error": str(e)})
    finally:
        _close_file_handler(get_logger(), log_path)
    # merge with any prior summary so partial runs don't erase other
    # experiments' recorded status
    path = os.path.join(args.output_dir, "run_summary.json")
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = {s["experiment"]: s for s in json.load(f)}
        except (json.JSONDecodeError, KeyError, TypeError):
            merged = {}
    merged.update({s["experiment"]: s for s in summary})
    with open(path, "w") as f:
        json.dump([merged[k] for k in sorted(merged)], f, indent=2)
    return 0 if all(s["ok"] for s in summary) else 1


def _close_file_handler(logger: logging.Logger, path: str) -> None:
    """Detach and close the run's log file, so repeated in-process runs do
    not keep earlier runs' files open."""
    for h in list(logger.handlers):
        if (isinstance(h, logging.FileHandler)
                and h.baseFilename == os.path.abspath(path)):
            logger.removeHandler(h)
            h.close()


def _gates_passed(results):
    """Extract a pass/fail verdict from an experiment's result payload:
    True/False when it carries an `all_passed` flag (recursively), None when
    it has no gates. Recurses into lists too, and treats a per-row `passed`
    flag inside a list element as a gate verdict — experiment drivers carry
    gates both ways."""
    if isinstance(results, dict):
        if "all_passed" in results:
            return bool(results["all_passed"])
        if "passed" in results and isinstance(results["passed"],
                                              (bool, np.bool_)):
            return bool(results["passed"])
        children = results.values()
    elif isinstance(results, (list, tuple)):
        children = results
    else:
        return None
    verdicts = [_gates_passed(v) for v in children]
    verdicts = [v for v in verdicts if v is not None]
    if verdicts:
        return all(verdicts)
    return None


if __name__ == "__main__":
    sys.exit(main())
