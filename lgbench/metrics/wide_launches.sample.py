"""Launches a call that the port sent to a WIDE instantiation (B1, B2, B3
or B6 carrying y's wide parts, past |y| 256): its `lgm.route.wide` spans
over the calls of the traced window. None without the sampling entry span
(`lgm.entry.sample_iid`), and None where no launch took that span: a
program without it, or a cell that left the WIDE route."""

ENTRY, WIDE = "lgm.entry.sample_iid", "lgm.route.wide"


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    names = [name for name, _, _ in ctx.trace.host]
    if ENTRY not in names or WIDE not in names:
        return None
    return names.count(WIDE) / ctx.trace.calls
