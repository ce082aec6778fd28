"""B7's share of its roofline: the bound of one launch at the cell's
shapes (`lgbench/roofline/b7.py`) over its measured device time a launch
in the traced window, in %."""

from lgbench.metrics import _kernels


def read(ctx):
    return _kernels.roofline_pct(ctx, "b7")
