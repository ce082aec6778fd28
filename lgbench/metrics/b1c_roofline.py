"""Centred B1's share of its roofline: the bound of a call's draws, one a
message at the cell's shapes (`lgbench/roofline/b1c.py`), over the device
time of the centred instantiation a call in the traced window (the call's
redraw launches included), in %."""

from lgbench import roofline
from lgbench.roofline import b1c


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    seconds, launches = ctx.trace.kernel(b1c.SYMBOL)
    if not launches or seconds <= 0:
        return None
    bound_s, _ = roofline.bound(b1c.count(ctx.shapes))
    return 100.0 * bound_s / (seconds / ctx.trace.calls)
