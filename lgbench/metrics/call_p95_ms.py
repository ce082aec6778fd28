"""95th percentile over all calls of the window of the host time from a
call's issue to its result synchronised, in ms."""

import statistics


def read(ctx):
    lat = ctx.latencies_s
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
