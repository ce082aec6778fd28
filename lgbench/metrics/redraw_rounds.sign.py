"""Redraw rounds a call of the port's signer: its `lgm.sign.redraw` spans
(one a round, which redraws every message of the call still above the
norm bound) over the calls of the traced window; None for a program
without the signer's entry span (`lgm.entry.sign`)."""

ENTRY, REDRAW = "lgm.entry.sign", "lgm.sign.redraw"


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    names = [name for name, _, _ in ctx.trace.host]
    if ENTRY not in names:
        return None
    return names.count(REDRAW) / ctx.trace.calls
