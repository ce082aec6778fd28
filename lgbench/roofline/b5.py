"""B5, one round of Peikert's sampler a launch (`csrc/peikert_tc.cu`). A
draw of dimension n: n standard normals (a Box-Muller pair takes a log, a
square root, a cosine and a sine), the triangular product L2 z, n(n+1)/2
multiply-adds, and n independent windows of W weights; reads L2's triangle
and the centre, writes the draw (n float32)."""

SYMBOL = r"peikert_tc_kernel<"


def count(shapes: dict) -> dict:
    n, W, B = shapes["n"], shapes["window"], shapes["chains"]
    rounds = shapes.get("rounds", 1)
    return {"mma_flop": rounds * B * n * (n + 1),
            "exp": rounds * B * n * (W + 2),
            "bytes": 4 * (n * (n + 1) // 2 + n) + 4 * rounds * B * n}
