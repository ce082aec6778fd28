"""B7, Babai's nearest plane on recentred centres (`csrc/klein_tc.cu`,
Babai mode). A target of dimension n: the coupling, n(n-1)/2
multiply-adds, and n roundings; reads the centres (n float32) and U's
triangle, writes the coefficients (n float32)."""

SYMBOL = r"klein_tc_kernel<\s*\d+\s*,\s*\w+\s*,\s*\w+\s*,\s*true"


def count(shapes: dict) -> dict:
    n, B = shapes["n"], shapes["targets"]
    return {"mma_flop": B * n * (n - 1),
            "exp": 0,
            "bytes": 4 * n * (n + 1) // 2 + 2 * 4 * B * n}
