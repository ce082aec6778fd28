"""Memory statistics for the benchmark rows (the part of the JAX package's
`utils/profiling.py` the suite needs): host peak RSS and the CUDA caching
allocator's counters."""

from __future__ import annotations

from typing import Any, Dict

import torch


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
