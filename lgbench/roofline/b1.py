"""B1, a Klein draw a chain (`csrc/klein_tc.cu`, draw mode). A draw of
dimension n: the coupling sum_{j>i} U_ij x_j over all rows, n(n-1)/2
multiply-adds; n windows of W weights (exps) and n log-normalisers; reads
U's triangle, the centres and widths (float32), writes the draw (n float32)
and its log-weight."""

SYMBOL = r"klein_tc_kernel<\s*\d+\s*,\s*false\s*,\s*false\s*,\s*false"


def count(shapes: dict) -> dict:
    n, W, B = shapes["n"], shapes["window"], shapes["chains"]
    return {"mma_flop": B * n * (n - 1),
            "exp": B * n * (W + 1),
            "bytes": 4 * (n * (n + 1) // 2 + 2 * n) + 4 * B * (n + 1)}
