"""Device time a call in everything but the port's kernels B1-B8 (cuBLAS
float64 products, copies, casts, element-wise operations), in ms."""

from lgbench.metrics import _kernels


def read(ctx):
    return _kernels.offkernel_ms(ctx)
