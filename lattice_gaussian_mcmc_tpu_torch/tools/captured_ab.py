"""The plain chains' drivers on the card, captured against eager.

    python3 -m lattice_gaussian_mcmc_tpu_torch.tools.captured_ab \
        [--out DIR] [NAME ...]

Runs in one process on the first CUDA card, for each NAME (all by
default):

  imhk_2d_step  the 2D IMHK step of klein_validation's hard regime
                ([[1, .5], [0, 1]], sigma 0.35, one chain): ms a step by
                CUDA events, over 1,000 replays of one captured step and
                over 200 eager steps
  run_suite     experiments/klein_validation.py run_suite at its full
                budgets
  run_study     experiments/convergence_study.py run_study at
                ConvergenceConfig's defaults (50,000 draws)
  run_decoding  experiments/decoding.py run_decoding at its defaults, with
                the Gibbs and MHK decodes/s of every cell
  mesh_row      experiments/mesh_scaling.py measure_scaling at world size
                1 (the per-row card row of the CLI's mesh experiment):
                samples/s

each driver twice: captured (as it runs: one CUDA graph a step or sweep,
`utils/graphs.py`), then eager (`graphs.StepGraph` swapped for
`graphs.EagerSteps`, the CPU's route, on the card). Both runs draw the
same numbers, so their results (less their times) must be equal; the line
says so. Prints one JSON line a driver with the card's name and power
limit, and writes them all to DIR/captured_ab.json (DIR defaults to
suite_results/captured_ab; the drivers' own outputs go to DIR/<mode>/).
Exits 2 with no card, 1 if a driver failed its gates or the two runs
differ.
"""

from __future__ import annotations

import json
import os
import sys
import time

NAMES = ("imhk_2d_step", "run_suite", "run_study", "run_decoding",
         "mesh_row")
REPLAYS, EAGER_STEPS = 1000, 200


class Eager:
    """Within it `graphs.stepper` steps CUDA states eagerly."""

    def __init__(self, graphs):
        self.graphs = graphs

    def __enter__(self):
        self.real = self.graphs.StepGraph
        self.graphs.StepGraph = self.graphs.EagerSteps

    def __exit__(self, *exc):
        self.graphs.StepGraph = self.real


def untimed(obj) -> str:
    """`obj` as JSON without the entries that hold a time or a rate (keys
    "seconds", "..._s" and "...per_sec..."): they differ between runs."""
    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()
                    if not (k == "seconds" or k.endswith("_s")
                            or "per_sec" in k)}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o
    return json.dumps(strip(obj), sort_keys=True, default=float)


def step_ms(dev):
    """The 2D IMHK step's ms, captured (a replay) and eager."""
    import numpy as np
    import torch

    from lattice_gaussian_mcmc_tpu_torch.lattices import lattice_from_basis
    from lattice_gaussian_mcmc_tpu_torch.samplers import (
        imhk_init,
        klein_precompute,
    )
    from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import _imhk_move
    from lattice_gaussian_mcmc_tpu_torch.utils import graphs
    lat = lattice_from_basis(np.array([[1.0, 0.5], [0.0, 1.0]]), device=dev)
    pre = klein_precompute(lat, 0.35)
    st = imhk_init(pre, 1, seed=1)

    def move(step, *x):
        return _imhk_move(step, *x, pre, 1, 0)

    def events_ms(fn, k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(k)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k

    g = graphs.StepGraph(move, (st.coeffs, st.log_w, st.accepted))
    g.replay(1)
    e = graphs.EagerSteps(move, (st.coeffs, st.log_w, st.accepted))
    e.replay(1)
    return {"captured_ms": events_ms(g.replay, REPLAYS),
            "eager_ms": events_ms(e.replay, EAGER_STEPS),
            "replays_timed": REPLAYS, "eager_steps_timed": EAGER_STEPS}


def drivers(dev):
    """NAME -> a function of the output directory giving (result, passed)."""
    from lattice_gaussian_mcmc_tpu_torch.experiments import (
        convergence_study,
        decoding,
        klein_validation,
        mesh_scaling,
    )
    from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
        ConvergenceConfig,
    )
    from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import make_mesh

    def suite(d):
        r = klein_validation.run_suite(output_dir=d, device=dev)
        return r, r["all_passed"]

    def study(d):
        r = convergence_study.run_study(ConvergenceConfig(output_dir=d),
                                        device=dev)
        return r, r["all_passed"]

    def decode(d):
        r = decoding.run_decoding(decoding.DecodingConfig(output_dir=d),
                                  device=dev)
        return r, r["all_passed"]

    def mesh_row(d):
        r = mesh_scaling.measure_scaling(make_mesh(dev))
        return r, True

    return {"run_suite": suite, "run_study": study,
            "run_decoding": decode, "mesh_row": mesh_row}


def main(argv=None) -> int:
    import subprocess

    import torch
    args = list(sys.argv[1:] if argv is None else argv)
    out = os.path.join("suite_results", "captured_ab")
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    names = args or list(NAMES)
    if set(names) - set(NAMES):
        raise SystemExit(f"unknown: {sorted(set(names) - set(NAMES))}")
    if not torch.cuda.is_available():
        print("captured_ab: no CUDA device", file=sys.stderr)
        return 2
    from lattice_gaussian_mcmc_tpu_torch.utils import graphs
    dev = torch.device("cuda", 0)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    card = r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"
    os.makedirs(out, exist_ok=True)
    lines, ok = [], True
    runs = drivers(dev)
    for name in names:
        if name == "imhk_2d_step":
            line = {"driver": name, **step_ms(dev)}
        else:
            line = {"driver": name}
            results = {}
            for mode in ("captured", "eager"):
                graphs.reset_counts()
                d = os.path.join(out, mode, name)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "eager":
                    with Eager(graphs):
                        res, passed = runs[name](d)
                else:
                    res, passed = runs[name](d)
                torch.cuda.synchronize()
                results[mode] = res
                line[mode] = {"wall_s": time.perf_counter() - t0,
                              "passed": bool(passed),
                              "graph_captures": graphs.StepGraph.captures,
                              "graph_replays": graphs.StepGraph.replays,
                              "graph_capture_s": graphs.StepGraph.capture_s}
                if name == "run_decoding":
                    line[mode]["decodes_per_s"] = [
                        {k: row[k] for k in (
                            "n", "rho", "decodes_per_sec_gibbs",
                            "decodes_per_sec_mhk", "decodes_per_sec_babai")}
                        for row in res["rows"]]
                if name == "mesh_row":
                    line[mode]["samples_per_sec"] = res["samples_per_sec"]
            line["same_results"] = (untimed(results["captured"])
                                    == untimed(results["eager"]))
            line["eager_over_captured"] = (line["eager"]["wall_s"]
                                           / line["captured"]["wall_s"])
            ok = (ok and line["same_results"] and line["captured"]["passed"]
                  and line["eager"]["passed"]
                  and line["captured"]["graph_replays"] > 0
                  and line["eager"]["graph_replays"] == 0)
        line["card"] = card
        print(json.dumps(line, default=float), flush=True)
        lines.append(line)
    with open(os.path.join(out, "captured_ab.json"), "w") as f:
        json.dump(lines, f, indent=1, default=float)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
