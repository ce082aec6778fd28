"""Centred B1, one Klein draw a chain around its own centres
(`csrc/klein_tc.cu`, the CENTRED instantiation): B1's count (`b1.py`) and
each chain's n centres (float32) read once."""

from lgbench.roofline import b1

SYMBOL = (r"klein_tc_kernel<\s*\d+\s*,\s*false\s*,\s*false\s*,\s*false\s*,"
          r"\s*false\s*,\s*true")


def count(shapes: dict) -> dict:
    out = b1.count(shapes)
    out["bytes"] += 4 * shapes["chains"] * shapes["n"]
    return out
