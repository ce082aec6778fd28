"""Device idle time a call inside the port's signing entry point
(`lgm.entry.sign`, `FalconSigner.sign`), in ms; None for a program
without that span."""

from lgbench.metrics import _spans

ENTRY = "lgm.entry.sign"


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    spans = []
    for t0, t1 in sorted((t0, t1) for name, t0, t1 in ctx.trace.host
                         if name == ENTRY):
        if spans and t0 <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], t1))
        else:
            spans.append((t0, t1))
    if not spans:
        return None
    return 1e3 * _spans._inside(ctx.trace.gaps(), spans) / ctx.trace.calls
