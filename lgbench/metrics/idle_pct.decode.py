"""Share of the traced window in which no kernel, copy or fill ran on the
card, in %."""

from lgbench.metrics import _kernels


def read(ctx):
    return _kernels.idle_pct(ctx)
