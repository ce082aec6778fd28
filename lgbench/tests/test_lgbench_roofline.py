"""The frozen roofline counts, checked by hand arithmetic at small shapes,
and the kernel symbols they match in the profiler's trace."""

import re

import pytest

from lgbench import roofline
from lgbench.roofline import b1, b2, b5, b7

PK = {"tensor_flop_s": 1e3, "exp_op_s": 1e2, "hbm_bytes_s": 1e1}


def test_b1_counts_by_hand():
    # n = 4, W = 2, 3 chains: the coupling 4*3/2 = 6 multiply-adds a draw;
    # 4 windows of 2 exps plus 4 logs; U's triangle 10 + centre and widths
    # 8 floats read, draw and log-weight 3 * 5 floats written
    c = b1.count({"n": 4, "window": 2, "chains": 3})
    assert c == {"mma_flop": 36, "exp": 36, "bytes": 4 * 18 + 4 * 15}


def test_b2_counts_by_hand():
    # 5 steps of 3 chains at n = 4, W = 2: 5 * 3 * 12 FLOP; 5 * 3 * (12 + 1)
    # transcendentals; the state (4 coefficients, log-weight, count) read
    # and written once: 2 * 3 * 6 floats, with 18 floats of operands
    c = b2.count({"n": 4, "window": 2, "chains": 3, "steps": 5})
    assert c == {"mma_flop": 180, "exp": 195, "bytes": 4 * 18 + 2 * 4 * 18}


def test_b5_counts_by_hand():
    # n = 4, W = 2, 3 chains: L2 z is 4*5/2 = 10 multiply-adds; 4 windows of
    # 2 exps and 2 Box-Muller operations a coordinate; L2's triangle and the
    # centre read (14 floats), 12 floats written
    c = b5.count({"n": 4, "window": 2, "chains": 3})
    assert c == {"mma_flop": 60, "exp": 48, "bytes": 4 * 14 + 4 * 12}


def test_b7_counts_by_hand():
    c = b7.count({"n": 4, "targets": 3})
    assert c == {"mma_flop": 36, "exp": 0, "bytes": 4 * 10 + 2 * 4 * 12}


def test_bound_is_the_largest_term():
    assert roofline.bound({"mma_flop": 1000, "exp": 50, "bytes": 2},
                          PK) == (1.0, "mma")
    assert roofline.bound({"mma_flop": 10, "exp": 500, "bytes": 2},
                          PK) == (5.0, "exp")
    s, by = roofline.bound({"mma_flop": 10, "exp": 5, "bytes": 300}, PK)
    assert (s, by) == (30.0, "bytes")


def test_published_peaks():
    pk = roofline.peaks()
    assert (pk["tensor_flop_s"], pk["exp_op_s"], pk["hbm_bytes_s"]) == (
        989e12, 67e12, 3.35e12)


def test_flagship_bound():
    # 64 steps x 524,288 chains x 1024 x 1023 FLOP at 989 TFLOP/s
    s, by = roofline.bound(b2.count({"n": 1024, "window": 16,
                                     "chains": 524288, "steps": 64}))
    assert by == "mma"
    assert s == pytest.approx(64 * 524288 * 1024 * 1023 / 989e12)


ANON = "void (anonymous namespace)::"
# the kernels' names as the profiler's trace gives them on the card
NAMES = {
    "b1": ANON + "klein_tc_kernel<16, false, false, false, false>"
                 "(lgk::TcOperands, lgk::Uniforms, float const*, float*)",
    "b6": ANON + "klein_tc_kernel<16, true, false, false, false>"
                 "(lgk::TcOperands, lgk::Uniforms, float const*, float*)",
    "b7": ANON + "klein_tc_kernel<0, false, false, true, false>"
                 "(lgk::TcOperands, lgk::Uniforms, float const*, float*)",
    "b2": ANON + "imhk_tc_kernel<16, false, false>(lgk::TcOperands, "
                 "lgk::Uniforms, float*)",
    "b5": ANON + "peikert_tc_kernel<24, false, 32>(float4 const*, "
                 "float const*, float, int)",
}


@pytest.mark.parametrize("kernel", ["b1", "b2", "b5", "b7"])
def test_symbols_pick_their_kernel_alone(kernel):
    mod = {"b1": b1, "b2": b2, "b5": b5, "b7": b7}[kernel]
    hits = [k for k, name in NAMES.items() if re.search(mod.SYMBOL, name)]
    assert hits == [kernel]


def test_port_kernels_cover_every_kernel_name():
    pats = roofline.port_kernel_patterns()
    for name in NAMES.values():
        assert any(p in name for p in pats)
    assert not any(p in "void at::native::elementwise_kernel<128, 2>"
                   for p in pats)
