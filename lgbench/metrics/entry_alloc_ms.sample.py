"""Host time a call in CUDA allocation and release calls (`cudaMalloc*`,
`cudaFree*`) inside the port's sampling entry points
(`lgm.entry.sample_iid`, `lgm.entry.peikert_sample`), in ms."""

from lgbench.metrics import _spans


def read(ctx):
    return _spans.alloc_ms(ctx, "sample")
