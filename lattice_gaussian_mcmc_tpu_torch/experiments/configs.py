"""Typed experiment configuration (counterpart of the JAX package's
`experiments/configs.py`). The kernels compute in float32 and the host QR
in float64; neither is a setting here, so the JAX configs' `dtype` is not
a field. No JAX driver reads `n_devices` or `save_samples`, so they are
not fields either (the mesh experiment's world sizes are its own).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

# sigma regimes as multiples of the smoothing parameter eta
SIGMA_REGIMES: Dict[str, float] = {
    "hard": 0.5,
    "near": 1.0,
    "smooth": 2.0,
    "very_smooth": 5.0,
}


@dataclass
class ExperimentConfig:
    """Common knobs: output location and seed."""

    output_dir: str = "results"
    seed: int = 42

    def ensure_output(self) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        return self.output_dir

    def dump(self, name: str) -> None:
        path = os.path.join(self.ensure_output(), f"{name}_config.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)


@dataclass
class ConvergenceConfig(ExperimentConfig):
    dimensions: Sequence[int] = (2, 4, 8, 16)
    sigma_factors: Sequence[float] = (0.5, 1.0, 2.0, 5.0)
    n_samples: int = 50_000
    n_chains: int = 8
    burn_in: int = 500
    enumeration_radius: int = 10     # ground truth box (small n only)
    tvd_checkpoints: Sequence[int] = (10, 30, 100, 300, 1000, 3000, 10000)


@dataclass
class ScalingConfig(ExperimentConfig):
    dimensions: Sequence[int] = (16, 32, 64, 128, 256, 512)
    n_samples: int = 20_000
    n_chains_grid: Sequence[int] = (256, 1024, 4096, 16384)
    sigma_factor: float = 2.0
    asymptotic_dims: Sequence[int] = (512, 1024, 2048)


@dataclass
class CryptoConfig(ExperimentConfig):
    ntru_n: Sequence[int] = (64, 256, 512)
    ntru_q: int = 12289
    qary_dims: Sequence[int] = (64, 128, 256)
    qary_q: int = 3329
    n_samples: int = 20_000
    n_chains: int = 1024
    checkpoint_every: int = 5        # experiments between checkpoint writes
    # the cached NTRU keys (the JAX package reads "bench_cache" too)
    cache_dir: str = "bench_cache"


@dataclass
class SensitivityConfig(ExperimentConfig):
    dimension: int = 16
    sweep_dimensions: Sequence[int] = (8, 16, 32)  # sigma x dim grid
    sigma_grid_size: int = 17
    sigma_range: Tuple[float, float] = (0.25, 8.0)   # x eta
    reductions: Sequence[str] = ("none", "lll", "bkz")
    center_modes: Sequence[str] = ("origin", "random", "deep_hole")
    n_samples: int = 30_000


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
