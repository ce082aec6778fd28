"""Process start to the end of the warm-up call: imports, the key and
basis, the port's precomputation and operands, the cell's inputs, one call
at the cell's own shapes (and, in a fresh checkout, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
