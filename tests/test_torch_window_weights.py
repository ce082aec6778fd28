"""The window's weights as the kernels compute them (klein_common.cuh): in
segments of 8 offsets aligned on the centre, each walked away from the
centre from its anchor by a product recurrence, held here on their plain
version (`klein_cuda._window_weights_plain`) to float64 exp, the draws to a
float64 inverse CDF and the log-normalisers to float64; and the SASS reader
that counts a row's instructions (`tools/sass.py`)."""

import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda, smk_cuda
from lattice_gaussian_mcmc_tpu_torch.tools import sass
from lgbench.reference.dgauss import icdf

DRAWS = 1 << 20
# float32 weights, each within a few ulp of its argument's exp: an anchor
# takes one accurate exp, a weight k <= 7 steps out picks up O(k^2) ulp
WEIGHT_RTOL = 2.0 ** -18
# a draw flips only where u total falls within rounding of a CDF step
MAX_DIFFER = 2e-5
LOGZ_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _row_args(c, isg):
    base = torch.round(c)
    delta = base - c
    a = isg * isg
    return (-a) * delta, a


def _grid():
    """(delta, isg) over delta in [-1/2, 1/2] and sigma_i in [1.2, 2.0],
    float32, centres around 0 so that base = 0."""
    delta = torch.linspace(-0.5, 0.5, 101)
    sig = torch.linspace(1.2, 2.0, 41)
    d, s = torch.meshgrid(delta, sig, indexing="ij")
    return (-d).reshape(-1).float(), (1.0 / s).reshape(-1).float()


@pytest.mark.parametrize("window", [16, 24, 40, 104])
def test_weights_within_2_18_of_float64_exp(window):
    c, isg = _grid()
    nad, a = _row_args(c, isg)
    w = klein_cuda._window_weights_plain(nad, a, window)
    assert w.dtype == torch.float32 and w.shape == (window, c.numel())
    offs = (torch.arange(window, dtype=torch.float64)
            - window // 2)[:, None]
    want = torch.exp(offs * nad.double() - a.double() * offs * offs / 2)
    heavy = want >= want.sum(0) * 2.0 ** -24
    rel = ((w.double() - want).abs() / want)[heavy]
    assert float(rel.max()) <= WEIGHT_RTOL, float(rel.max())


def test_weights_at_the_anchors_are_the_one_exp_each():
    # w(0) = 1 exactly; every other anchor's weight is the accurate exp of
    # off nad + (off^2 / 2)(-a), the argument rounded as written
    c, isg = _grid()
    nad, a = _row_args(c, isg)
    w = klein_cuda._window_weights_plain(nad, a, 40)
    for off in (0, 8, 16, -1, -9, -17):
        got = w[off + 20]
        want = torch.exp(off * nad + (0.5 * off * off) * (-a))
        assert torch.equal(got, want), off
    assert torch.equal(w[20], torch.ones_like(c))


@pytest.mark.parametrize("window,segments", [
    (16, ((-1, -8), (0, 7))),
    (24, ((-9, -12), (-1, -8), (0, 7), (8, 11))),
    (40, ((-17, -20), (-9, -16), (-1, -8), (0, 7), (8, 15), (16, 19))),
])
def test_windows_split_into_segments_anchored_at_the_centre(window,
                                                            segments):
    assert klein_cuda.window_segments(window) == segments
    # each segment is at most 8 offsets, and together they are the window
    offs = []
    for anchor, last in segments:
        assert abs(last - anchor) < klein_cuda.SEGMENT
        assert anchor in {0, -1} or anchor % 8 in {0, 7}
        offs += range(min(anchor, last), max(anchor, last) + 1)
    assert offs == list(range(-(window // 2), window - window // 2))


@pytest.mark.parametrize("window", [16, 24, 40])
def test_runtime_window_weights_are_the_compile_time_ones(window):
    # a weight is a function of its offset alone, so a wider runtime window
    # (104, cut into the same segments and more) gives each offset of the
    # compiled window the same weight bit for bit, and so do the two halves
    # of a chain's pair
    c, isg = _grid()
    nad, a = _row_args(c, isg)
    w = klein_cuda._window_weights_plain(nad, a, window)
    wide = klein_cuda._window_weights_plain(nad, a, 104)
    lo = 52 - window // 2
    assert torch.equal(w, wide[lo:lo + window])


@pytest.mark.parametrize("window", [16, 24, 40])
def test_draws_match_float64_inverse_cdf(window):
    g = torch.Generator().manual_seed(window)
    c = (torch.rand(DRAWS, generator=g) * 40 - 20).float()
    isg = (1.0 / (1.2 + 0.8 * torch.rand(DRAWS, generator=g))).float()
    u = torch.rand(DRAWS, generator=g).float()
    z, logz = klein_cuda._draw_row_plain(c, isg, u, window)
    z64, logz64 = icdf(u.double(), c.double(), 1.0 / isg.double(), window)
    assert float((z.double() != z64).double().mean()) <= MAX_DIFFER
    assert float((logz.double() - logz64).abs().max()) <= LOGZ_ATOL


@pytest.mark.parametrize("window", [16, 24, 40, 104])
def test_log_normalizers_match_float64_and_the_draw(window):
    g = torch.Generator().manual_seed(window + 1)
    c = (torch.rand(64, 512, generator=g) * 40 - 20).float()
    isg = (1.0 / (1.2 + 0.8 * torch.rand(64, 1, generator=g))).float()
    logz = smk_cuda._log_normalizer_plain(c, isg, window)
    _, want = icdf(torch.zeros_like(c).double(), c.double(),
                   1.0 / isg.double(), window)
    assert float((logz.double() - want).abs().max()) <= LOGZ_ATOL
    # the draw's log Z is the same sum, bit for bit
    _, lz = klein_cuda._draw_row_plain(c[0], isg[0], torch.rand(512), window)
    assert torch.equal(lz, logz[0])


LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_114imhk_tc_kernelILi16ELb0ELb0EEEvv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   NOP ;
.L_x_1:
        /*0020*/                   MUFU.EX2 R3, R3 ;
.L_x_2:
        /*0030*/                   FMUL R3, R3, R4 ;
        /*0040*/               @P1 BRA `(.L_x_2) ;
        /*0050*/                   MUFU.EX2 R5, R5 ;
        /*0060*/              @!P0 BRA `(.L_x_1) ;
        /*0070*/                   BRA 0x20 ;
        /*0080*/                   EXIT ;
\t\tFunction : probe_store
        /*0000*/                   EXIT ;
"""


def test_sass_draw_loop_is_the_smallest_loop_with_an_exp():
    name = sass.function_name(LISTING, "imhk_tc_kernelILi16ELb0ELb0E")
    assert name.endswith("EEEvv")
    # .L_x_2's loop holds no exp; .L_x_1's (0x20 .. 0x60) holds two, and
    # the branch to 0x20 makes a larger one
    assert sass.draw_loop(LISTING, name) == {"instructions": 5, "ex2": 2}
    with pytest.raises(ValueError):
        sass.function_name(LISTING, "klein_tc_kernel")
