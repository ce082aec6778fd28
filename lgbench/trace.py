"""The traced run: `torch.profiler` over the measured window, reduced to
what the per-layer metrics read.

The window and each entry call are marked by the benchmark's own spans
(`record_function`: "lgbench.window", "lgbench.call"). The device's
activity is every kernel, copy and fill of the trace inside the window;
its union is the busy time. An idle gap is a stretch of the window with no
device activity, named by the innermost host event (an operator, a runtime
call or a span) running at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW, CALL = "lgbench.window", "lgbench.call"


@contextlib.contextmanager
def profiled(enabled: bool, box: dict):
    """Profile the CPU and the card while the block runs, if enabled; the
    reduced trace goes to box["trace"] on exit."""
    if not enabled:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["trace"] = Trace(json.load(f))
    finally:
        os.remove(path)


class Trace:
    """Device intervals, host events and the window, in seconds."""

    def __init__(self, chrome: dict):
        events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
        dev, host, win = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, t0 = e.get("cat", ""), float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                dev.append((e["name"], t0, t1))
            elif cat in HOST_CATS:
                host.append((e["name"], t0, t1))
                if e["name"] == WINDOW and cat == "user_annotation":
                    win = (t0, t1)
        if win is None:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        self.window = win
        self.device = sorted(
            (d for d in dev if d[2] > win[0] and d[1] < win[1]),
            key=lambda d: d[1])
        self.host = [h for h in host if h[2] > win[0] and h[1] < win[1]]
        self.calls = sum(1 for h in self.host if h[0] == CALL)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self):
        a, b = self.window
        for name, t0, t1 in self.device:
            yield name, max(t0, a), min(t1, b)

    def busy_s(self) -> float:
        """Length of the union of device activity inside the window."""
        total, end = 0.0, None
        for _, t0, t1 in self._clipped():
            if end is None or t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def gaps(self):
        """Idle stretches (start, end) of the window."""
        out, cur = [], self.window[0]
        for _, t0, t1 in self._clipped():
            if t0 > cur:
                out.append((cur, t0))
            cur = max(cur, t1)
        if self.window[1] > cur:
            out.append((cur, self.window[1]))
        return out

    def host_at(self, times):
        """The innermost host event running at each of the sorted times:
        of the events open then, the one that started last."""
        events = sorted(self.host, key=lambda h: h[1])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(events) and events[i][1] <= t:
                stack.append(events[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0] if stack else "no host event")
        return out

    def kernel(self, pattern: str):
        """(device seconds, launches) of kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [t1 - t0 for name, t0, t1 in self.device if rx.search(name)]
        return sum(hits), len(hits)

    def outside(self, patterns) -> float:
        """Device seconds in activity matching none of the patterns."""
        rx = [re.compile(re.escape(p)) for p in patterns]
        return sum(t1 - t0 for name, t0, t1 in self.device
                   if not any(r.search(name) for r in rx))

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for name, t0, t1 in self.device:
            ops[name] = ops.get(name, 0.0) + (t1 - t0)
        idle: dict = {}
        gaps = self.gaps()
        for (a, b), what in zip(gaps, self.host_at([0.5 * (a + b)
                                                    for a, b in gaps])):
            idle[what] = idle.get(what, 0.0) + (b - a)

        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
