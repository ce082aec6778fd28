"""Device idle time a call inside the port's decoding entry point
(`lgm.entry.nearest_plane`), in ms."""

from lgbench.metrics import _spans


def read(ctx):
    return _spans.idle_ms(ctx, "decode")
