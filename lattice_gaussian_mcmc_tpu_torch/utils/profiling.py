"""Sampling statistics, timing, tracing and cost counts (counterpart of the
JAX package's `utils/profiling.py`): `SamplingStats`, `timed` (the clock
read after the device is synchronised), `profile_trace` (a Chrome trace by
`torch.profiler`), `span` (the port's named ranges inside such a trace),
`memory_snapshot` (host peak RSS and the CUDA caching allocator's counters)
and `compiled_cost` (FLOPs counted by `torch.utils.flop_counter`).

Spans. The port marks its stages with `span(name)`, named `lgm.<kind>.<what>`:
`lgm.entry.*` the whole body of an entry point (`sample_iid`,
`peikert_sample`, `nearest_plane`), `lgm.kernel.b1` / `b2` / `b5` / `b7` one
kernel launch (or its plain version on the CPU), `lgm.route.wide` a launch
of B1, B2, B3 or B6 that `klein_cuda.wide_y` sent to its WIDE
instantiation (inside the kernel's span), `lgm.sync.*` a read that
waits for the card (`c8_guard`, `acceptance`), `lgm.operands.*` operands
built in a call (`babai`, `fragments`), `lgm.layout.*` the work between
kernels (`centres`, `recentre`, `coeffs`, `points`) and `lgm.setup.*` the
set-up (`build`, `qr`, `precompute`, `operands`, `burn_in`). Under
`torch.profiler` each is a `user_annotation` on the host and, around the
work it queued itself, a `gpu_user_annotation` on the card (the device side
names the innermost span), both on the profiler's clock; with no profiler
running a span does nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.utils.device import synchronize


@dataclasses.dataclass
class SamplingStats:
    """Samples, seconds, acceptance and ESS of a run, with the rates."""

    samples_generated: int = 0
    time_elapsed: float = 0.0
    acceptance_rate: float = 0.0
    ess: float = 0.0

    @property
    def samples_per_second(self) -> float:
        return (self.samples_generated / self.time_elapsed
                if self.time_elapsed else 0.0)

    @property
    def ess_per_second(self) -> float:
        return self.ess / self.time_elapsed if self.time_elapsed else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {**dataclasses.asdict(self),
                "samples_per_second": self.samples_per_second,
                "ess_per_second": self.ess_per_second}


# the context every span returns while no profiler runs
_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A named range of the trace: `torch.profiler.record_function(name)`
    while a profiler runs, else a shared no-op context (one call and one
    check: no clock read, no synchronisation, no allocation)."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """`torch.profiler` over the block (CPU, and CUDA when a card is
    present), its Chrome trace written to `log_dir/trace.json`; a no-op
    when log_dir is None. Yields the profiler (None when off). The trace
    holds the port's `span`s (`lgm.*`, module docstring) beside the
    operators, runtime calls and kernels."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(stats: SamplingStats, n_samples: int, device=None):
    """Add the block's wall seconds and n_samples to `stats`; the clock is
    read after `device`'s work (a card's queue) is done, at both ends."""
    device = torch.device(device) if device is not None else None
    if device is not None:
        synchronize(device)
    t0 = time.perf_counter()
    yield
    if device is not None:
        synchronize(device)
    stats.time_elapsed += time.perf_counter() - t0
    stats.samples_generated += n_samples


def memory_snapshot() -> Dict[str, Any]:
    """Host peak RSS in MB and, with a card, the allocator's bytes now
    allocated and reserved and the peak allocated since the last
    `torch.cuda.reset_peak_memory_stats()` (`torch.cuda.memory_stats`)."""
    out: Dict[str, Any] = {}
    try:
        import resource
        # ru_maxrss is KiB on Linux
        out["peak_rss_mb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except ImportError:  # pragma: no cover - non-POSIX
        pass
    if torch.cuda.is_available():
        stats = torch.cuda.memory_stats()
        out["device_bytes_allocated"] = stats.get(
            "allocated_bytes.all.current", 0)
        out["device_bytes_reserved"] = stats.get(
            "reserved_bytes.all.current", 0)
        out["device_peak_bytes_allocated"] = stats.get(
            "allocated_bytes.all.peak", 0)
    return out


def compiled_cost(fn, *args) -> Dict[str, Any]:
    """FLOPs of one call `fn(*args)` as `torch.utils.flop_counter` counts
    them (matrix products, convolutions, attention), under the JAX
    package's keys; torch counts no bytes or transcendentals, so those
    are None, and so are the FLOPs when it counted none."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return {"flops": flops or None, "bytes_accessed": None,
            "transcendentals": None}
