"""Readers shared by the kernel and device metrics of a traced run."""

from lgbench import roofline
from lgbench.roofline import b1, b2, b5, b7

KERNELS = {"b1": b1, "b2": b2, "b5": b5, "b7": b7}


def roofline_pct(ctx, kernel: str):
    if ctx.trace is None:
        return None
    mod = KERNELS[kernel]
    seconds, launches = ctx.trace.kernel(mod.SYMBOL)
    if not launches or seconds <= 0:
        return None
    bound_s, _ = roofline.bound(mod.count(ctx.shapes))
    return 100.0 * bound_s / (seconds / launches)


def offkernel_ms(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    return 1e3 * ctx.trace.outside(roofline.port_kernel_patterns()) \
        / ctx.trace.calls


def idle_pct(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
