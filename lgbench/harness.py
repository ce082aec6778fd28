"""One run of one cell: plan it from `BENCHMARK.json` and the files named
there, set it up, measure a closed-loop window, check what the window
produced against the plain reference, and read the cell's metrics.

Everything that belongs to one configuration, mix, cell or metric is a file
of its own, found by name under `lgbench/`:

    configs/<config>.json   the deployment: its lattice, width rules,
                            precision
    mixes/<traffic>.json    the traffic: entry point, sizes, how calls are made
    cells/<cell>.json       the check of a cell: rows sampled, limits
    entries/<entry>.py      the program's entry point the mix drives
    reference/<entry>.py    its plain reference
    metrics/<metric>.py     `read(ctx)` of one metric, None when it has
                            nothing to read
    roofline/<kernel>.py    a kernel's symbol and the algorithm's counts

A configuration names its lattice in one of two ways, as a path under
`lgbench/` with the file's sha256 beside it: "key" and "key_sha256", a
frozen NTRU key (an .npz with n, f, g, F, G) whose secret basis is the
lattice; or "basis" and "basis_sha256", a frozen integer basis (an .npz of
one int64 array "B", columns the basis vectors). "dimension" is the
basis's size, and "sigma_rules" maps a mix's "sigma_rule" to a width:
{"value": s}, {"factor": f, "eps": e} (f eta_e(Z^dim) s1(B)), or with
"of": "gs_max" f eta_e(Z^dim) max ||b*_i||. `plan` checks the file, its
hash and its shape before any set-up (`reference/lattice.py` `basis_of`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from types import ModuleType, SimpleNamespace

import numpy as np
import torch

from lgbench import trace as tr
from lgbench import traffic
from lgbench.reference import lattice

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "lattice_gaussian_mcmc_tpu")


class Bench:
    """`BENCHMARK.json` at `root` and the files of `root/lgbench`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "lgbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._mods: dict = {}

    def _named(self, key: str, name: str) -> dict:
        for item in self.spec[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def data(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._named("configs", name)["file"])) as f:
            return json.load(f)

    def module(self, kind: str, name: str) -> ModuleType:
        path = os.path.join(self.dir, kind, f"{name}.py")
        mod = self._mods.get(path)
        if mod is None:
            tag = f"lgbench_{kind}_{name}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(tag, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._mods[path] = mod
        return mod

    def metrics(self, cell: str, traced: bool) -> list:
        """The cell's metrics: its end-to-end ones, or with a trace its
        per-layer ones; a metric without "workloads" is every cell's."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Plan:
    name: str
    config: dict
    mix: dict
    check: dict
    basis: np.ndarray
    sigma: object
    device: torch.device
    entry: ModuleType
    reference: ModuleType
    metrics: list


def plan(bench: Bench, name: str, device, traced: bool = False) -> Plan:
    """Everything a run of cell `name` needs before its set-up."""
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    mix = bench.data("mixes", cell["traffic"])
    basis = lattice.basis_of(config, bench.dir)
    rule = mix.get("sigma_rule")
    sigma = (lattice.sigma_of(config["sigma_rules"][rule], basis)
             if rule else None)
    metrics = bench.metrics(name, traced)
    for m in metrics:
        bench.module("metrics", m["name"])
    return Plan(name=name, config=config, mix=mix,
                check=bench.data("cells", name), basis=basis, sigma=sigma,
                device=torch.device(device),
                entry=bench.module("entries", mix["entry"]),
                reference=bench.module("reference", mix["entry"]),
                metrics=metrics)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rows_per_call(mix: dict) -> int:
    return int(mix["chains"] if "chains" in mix else mix["batch"])


def compare(prog: torch.Tensor, expected: torch.Tensor) -> float:
    """Share of rows (points or coefficient vectors, integer-valued) that
    differ anywhere from the reference's; a NaN differs."""
    close = (prog.to(expected.device, torch.float64) - expected).abs().amax(
        dim=1) <= 0.5
    return float((~close).to(torch.float64).mean())


def cat_rows(parts: list) -> dict:
    return {k: torch.cat([p[k].cpu() for p in parts]) for k in parts[0]}


def pick(rows: dict, rng, most: int) -> tuple:
    """At most `most` rows, drawn from the run's generator; (rows, idx)."""
    m = next(iter(rows.values())).shape[0]
    if m <= most:
        return rows, torch.arange(m)
    idx = torch.as_tensor(np.sort(rng.choice(m, most, replace=False)))
    return {k: v[idx] for k, v in rows.items()}, idx


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(bench: Bench, name: str, seed: int, seconds: float, traced: bool,
        device, t_start: float) -> dict:
    """One run of cell `name`: the result's object, with the numbers
    compared to decide `correct` last, under "checks". (`run.py` adds the
    look for JAX modules and the card.)"""
    p = plan(bench, name, device, traced)
    dev = p.device
    calls = traffic.make(p.mix, p.basis, seed, dev)
    program = p.entry.Entry(p)
    out = program.call(calls.call(0).args)
    sync(dev)
    del out
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(seed)
    per_call = int(p.check["rows_per_call"])
    lat, prog_rows, ref_rows = [], [], []
    units, failed = 0, 0
    box: dict = {}
    with tr.profiled(traced, box):
        with torch.profiler.record_function(tr.WINDOW):
            t0 = time.perf_counter()
            t_end, k = t0, 0
            while t_end - t0 < seconds:
                k += 1
                call = calls.call(k)
                a = time.perf_counter()
                try:
                    with torch.profiler.record_function(tr.CALL):
                        out = program.call(call.args)
                        sync(dev)
                except Exception:      # a failed call is counted, not fatal
                    traceback.print_exc()
                    failed += 1
                    out = None
                t_end = time.perf_counter()
                lat.append(t_end - a)
                if out is not None:
                    units += out.shape[0]
                    idx = torch.as_tensor(rng.choice(
                        out.shape[0], per_call, replace=False))
                    prog_rows.append(out.index_select(0, idx.to(out.device)))
                    ref_rows.append(call.rows(idx))
                    del out
    window_s = t_end - t0
    dinfo = device_info(dev)
    if dev.type == "cuda":
        dinfo["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    del program
    calls.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = p.reference.Reference(p.basis, p.sigma, p.mix, dev)
    checked, differ = 0, 1.0
    if prog_rows:
        rows, idx = pick(cat_rows(ref_rows), rng, int(p.check["max_rows"]))
        prog = torch.cat(prog_rows)[idx.to(dev)]
        differ = compare(prog, ref.expected(rows))
        checked = prog.shape[0]
    checks = {
        "rows_differ": {"value": differ,
                        "limit": float(p.check["limits"]["rows_differ"])},
        "rows_checked": {"value": checked, "min": int(p.check["min_rows"])},
        "calls_failed": {"value": failed, "limit": 0},
    }
    correct = (differ <= checks["rows_differ"]["limit"]
               and checked >= checks["rows_checked"]["min"] and failed == 0)

    shapes = dict(p.mix, **ref.shapes())
    shapes.setdefault("targets", shapes.get("batch"))
    ctx = SimpleNamespace(plan=p, latencies_s=lat, units=units,
                          window_s=window_s, setup_s=setup_s,
                          trace=box.get("trace"), shapes=shapes)
    metrics = {}
    for m in p.metrics:
        v = bench.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(lat),
              "failed": failed, "metrics": metrics, "device": dinfo}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    if lat:
        ms = sorted(1e3 * x for x in lat)
        print(f"calls {len(ms)}, units {units}, window {window_s:.4f} s, "
              f"call median {statistics.median(ms):.4f} ms, "
              f"max {ms[-1]:.4f} ms, set-up {setup_s:.4f} s",
              file=sys.stderr)
    result["checks"] = checks
    return result
