"""B2, `steps` fused IMHK steps a launch (`csrc/imhk_tc.cu`). A step of a
chain is a Klein draw (B1's count) and one log for the accept; the state
(n float32 coefficients, log-weight, accept count) is read once and
written once a launch, with U's triangle, the centres and widths read
once."""

SYMBOL = r"imhk_tc_kernel<"


def count(shapes: dict) -> dict:
    n, W, B, S = (shapes["n"], shapes["window"], shapes["chains"],
                  shapes["steps"])
    return {"mma_flop": S * B * n * (n - 1),
            "exp": S * B * (n * (W + 1) + 1),
            "bytes": 4 * (n * (n + 1) // 2 + 2 * n) + 2 * 4 * B * (n + 2)}
