"""Readers of the port's entry spans in a traced run: the device's idle
time and the host's allocator time that lie inside an entry point's own
call. The port marks each call of an entry point with a span
(`lgm.entry.<entry>`, its `utils/profiling.py` `span`); idle time of the
window outside every entry span is the benchmark loop's. A program without
those spans gives None."""

import bisect
import math
import re

ENTRIES = {"sample": ("lgm.entry.sample_iid", "lgm.entry.peikert_sample"),
           "decode": ("lgm.entry.nearest_plane",)}
# the CUDA runtime's allocation and release calls (cudaMalloc,
# cudaMallocAsync, cudaMallocHost, cudaFree, cudaFreeAsync, ...)
ALLOC = re.compile(r"^cuda(Malloc|Free)")


def entry_spans(trace, kind: str) -> list:
    """The union of the entry spans of `kind` as sorted, disjoint (start,
    end) intervals, in seconds."""
    names = ENTRIES[kind]
    spans = sorted((t0, t1) for name, t0, t1 in trace.host if name in names)
    out = []
    for t0, t1 in spans:
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def _inside(intervals, spans) -> float:
    """Seconds of the sorted, disjoint `intervals` that lie inside the
    sorted, disjoint `spans`."""
    total, j = 0.0, 0
    for a, b in intervals:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total


def _contains(spans, t: float) -> bool:
    i = bisect.bisect_right(spans, (t, math.inf)) - 1
    return i >= 0 and t <= spans[i][1]


def idle_ms(ctx, kind: str):
    """Device idle ms a call inside the entry spans of `kind`."""
    if ctx.trace is None or not ctx.trace.calls:
        return None
    spans = entry_spans(ctx.trace, kind)
    if not spans:
        return None
    return 1e3 * _inside(ctx.trace.gaps(), spans) / ctx.trace.calls


def alloc_ms(ctx, kind: str):
    """Host ms a call in CUDA runtime allocation and release calls whose
    midpoint lies inside the entry spans of `kind`."""
    if ctx.trace is None or not ctx.trace.calls:
        return None
    spans = entry_spans(ctx.trace, kind)
    if not spans:
        return None
    total = sum(t1 - t0 for name, t0, t1 in ctx.trace.host
                if ALLOC.match(name) and _contains(spans, 0.5 * (t0 + t1)))
    return 1e3 * total / ctx.trace.calls
