"""Lattice points returned by all calls of the window over the wall time
from the window's start to the last call's synchronised end."""


def read(ctx):
    return ctx.units / ctx.window_s if ctx.units else None
