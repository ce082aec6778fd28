"""A tiny copy of the benchmark for CPU tests: the repository's harness
files under a temporary root, with cells on the NTRU-16 key (dimension 32)
at small sizes, run on the CPU with the kernels' plain versions."""

from __future__ import annotations

import json
import os
import shutil

from lgbench.reference.lattice import sha256

HERE = os.path.dirname(os.path.abspath(__file__))
LGBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(LGBENCH)

MIXES = {
    "tiny_imhk": {"entry": "imhk_sample_iid", "kind": "seeded",
                  "seed_stride": 1000000, "sigma_rule": "signing",
                  "tail_budget": 0.01, "chains": 64, "steps": 8},
    "tiny_peikert": {"entry": "peikert_sample", "kind": "seeded",
                     "seed_stride": 1000000, "sigma_rule": "peikert",
                     "eps": 0.01, "tail_budget": 0.01, "chains": 64},
    "tiny_decode": {"entry": "nearest_plane", "kind": "targets",
                    "batch": 64, "coeff_range": [-2, 2],
                    "noise": [0.05, 0.45]},
}
CELLS = {"tiny.imhk": "tiny_imhk", "tiny.peikert": "tiny_peikert",
         "tiny.decode": "tiny_decode"}


def make_root(tmp: str) -> str:
    """A root holding BENCHMARK.json and lgbench/ (the repository's files
    but its tests) plus the tiny configuration, mixes and cells."""
    root = os.path.join(tmp, "root")
    shutil.copytree(LGBENCH, os.path.join(root, "lgbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    d = os.path.join(root, "lgbench")
    shutil.copy(os.path.join(HERE, "data", "ntru_16_12289_0_g.npz"),
                os.path.join(d, "data"))
    with open(os.path.join(d, "configs", "falcon512.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", key="data/ntru_16_12289_0_g.npz",
               key_sha256=sha256(os.path.join(d, "data",
                                              "ntru_16_12289_0_g.npz")),
               n=16, dimension=32)
    write(os.path.join(d, "configs", "tiny.json"), cfg)
    spec["configs"].append({"name": "tiny", "source": "test key",
                            "file": "lgbench/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"})
    for name, mix in MIXES.items():
        write(os.path.join(d, "mixes", f"{name}.json"), mix)
    for cell, mix in CELLS.items():
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1, "why": "test"})
        write(os.path.join(d, "cells", f"{cell}.json"),
              {"rows_per_call": 16, "max_rows": 256, "min_rows": 16,
               "limits": {"rows_differ": 0.1}})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = {"samples_per_s": ("tiny.imhk", "tiny.peikert"),
                    "decodes_per_s": ("tiny.decode",),
                    "call_p95_ms": ("tiny.peikert", "tiny.decode")}
            m["workloads"] += list(kind.get(m["name"], ()))
    write(os.path.join(root, "BENCHMARK.json"), spec)
    return root


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
