"""Device idle time a call inside the port's sampling entry points
(`lgm.entry.sample_iid`, `lgm.entry.peikert_sample`), in ms."""

from lgbench.metrics import _spans


def read(ctx):
    return _spans.idle_ms(ctx, "sample")
