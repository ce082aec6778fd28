"""Host time a call in CUDA allocation and release calls (`cudaMalloc*`,
`cudaFree*`) inside the port's decoding entry point
(`lgm.entry.nearest_plane`), in ms."""

from lgbench.metrics import _spans


def read(ctx):
    return _spans.alloc_ms(ctx, "decode")
