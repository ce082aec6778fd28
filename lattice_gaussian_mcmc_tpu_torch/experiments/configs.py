"""Typed experiment configuration (the part of the JAX package's
`experiments/configs.py` the benchmark suite reads). The kernels compute
in float32 and the host QR in float64; neither is a setting here."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence


@dataclass
class ExperimentConfig:
    """Common knobs: output location and seed."""

    output_dir: str = "results"
    seed: int = 42

    def ensure_output(self) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        return self.output_dir


@dataclass
class BenchmarkConfig(ExperimentConfig):
    algorithms: Sequence[str] = ("klein", "imhk", "direct", "peikert")
    dimensions: Sequence[int] = (16, 64, 256, 1024)
    n_chains: int = 65_536
    warmup_runs: int = 1
    timed_runs: int = 3
    # the cached NTRU keys of the rows at n >= 256 (seed 42: ring degrees
    # 128 and 512)
    cache_dir: str = "bench_cache"
