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


# ---------------------------------------------------------------------------
# The runtime window's split draw (imhk_tc_common.cuh `draw_split`), mirrored
# step for step in float32 and held to the sequential inverse CDF of
# draw_row<0>'s plain version, draw for draw.
# ---------------------------------------------------------------------------

SEG = klein_cuda.SEGMENT
SPLIT_DRAWS = 2048
# every window from 2 to 129 in groups, and the largest
SPLIT_WINDOWS = [tuple(range(lo, min(lo + 16, 130))) for lo in range(2, 130, 16)]
SPLIT_WINDOWS.append((1024,))


def _anchor(q, up, nad, a, e):
    """imhk_tc_common.cuh `anchor_split`: segment q's (w, rho), q a tensor."""
    qf = q.to(torch.float32)
    off = SEG * qf if up else -SEG * qf - 1
    arg = off * nad + ((0.5 * off) * off) * (-a)
    x = torch.exp(arg)
    r = torch.exp((nad if up else -nad) + (off.abs() + 0.5) * (-a))
    w = torch.where(q == 0, torch.ones_like(x), x) if up else x
    rho = r if up else torch.where(q == 0, x * e, r)
    return w, rho


def _walk(w, rho, e):
    s = [w]
    for _ in range(1, SEG):
        w = w * rho
        rho = rho * e
        s.append(w)
    return s


def _split_draw(c, isg, u, window):
    """`draw_split` for each of the centres c (B,): the lower thread's
    segment-end CDFs in one pass far to near, the upper thread's anchors,
    its side walked again from the low sum, then on each side the whole
    segments that end below u total and the first that does not walked
    again. Returns (z, log Z)."""
    base = torch.round(c)
    delta = base - c
    a = isg * isg
    nad = (-a) * delta
    m = (-0.5 * a) * (delta * delta)
    e = torch.exp(-a)
    lo, hi = window // 2, window - window // 2
    J = -(-hi // SEG)
    n0 = lo - SEG * (J - 1)
    full = torch.full_like(c, 0, dtype=torch.int64)
    # the lower thread: steps 0 .. J-1 on segments J-1 .. 0
    run = torch.zeros_like(c)
    ends_lo, ends_up, anchors = [], [], []
    for j in range(J):
        w, rho = _anchor(full + (J - 1 - j), False, nad, a, e)
        s = _walk(w, rho, e)
        for t in range(SEG - 1, -1, -1):
            if j > 0 or t < n0:
                run = run + s[t]
        ends_lo.append(run)
        anchors.append(_anchor(full + j, True, nad, a, e))
    low = run
    # the upper thread: its side again from the kept anchors
    cum = low
    for j in range(J):
        s = _walk(*anchors[j], e)
        n = min(SEG, hi - SEG * j)
        for t in range(n):
            cum = cum + s[t]
        ends_up.append(cum)
    total = cum
    target = u * total

    def side(ends, up, start0):
        E = torch.stack(ends)                               # (J, B)
        k = (E < target).sum(0)
        kk = k.clamp(max=J - 1)
        prev = torch.gather(E, 0, (kk - 1).clamp(min=0)[None])[0]
        cdf = torch.where(kk > 0, prev, start0)
        q = kk if up else J - 1 - kk
        s = _walk(*_anchor(q, up, nad, a, e), e)
        n = ((hi - SEG * kk).clamp(max=SEG) if up
             else torch.where(kk == 0, torch.full_like(kk, n0),
                              torch.full_like(kk, SEG)))
        inside = torch.zeros_like(kk)
        for t in range(SEG):
            at = t if up else SEG - 1 - t
            ok = at < n
            cdf = torch.where(ok, cdf + s[at], cdf)
            inside = inside + (ok & (cdf < target)).to(kk.dtype)
        return k, inside

    kl, il = side(ends_lo, False, torch.zeros_like(c))
    ku, iu = side(ends_up, True, low)
    before = torch.where(kl == 0, torch.zeros_like(kl), n0 + SEG * (kl - 1))
    mine_lo = torch.where(kl == J, torch.full_like(kl, -1), before + il)
    mine_up = lo + torch.where(ku == J, torch.full_like(ku, hi),
                               SEG * ku + iu)
    idx = torch.where(mine_lo >= 0, mine_lo, mine_up).clamp(max=window - 1)
    return base + (idx - lo).to(c.dtype), m + torch.log(total)


def _split_rows(window, seed):
    """Centres straddling +-1/2 (and a few integers apart), widths 0.5 to
    200, uniforms over [0, 1) with 0 and the largest Philox uniform
    1 - 2^-23 among them, float32."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(-3, 4, (SPLIT_DRAWS,), generator=g).float()
    half = torch.where(torch.rand(SPLIT_DRAWS, generator=g) < 0.5, -0.5, 0.5)
    jit = (torch.rand(SPLIT_DRAWS, generator=g) - 0.5) * 2.0 ** -torch.randint(
        0, 24, (SPLIT_DRAWS,), generator=g).float()
    c = (k + half + jit).float()
    sig = 0.5 * (400.0 ** torch.rand(SPLIT_DRAWS, generator=g))
    isg = (1.0 / sig).float()
    u = torch.rand(SPLIT_DRAWS, generator=g).float()
    u[::17] = 0.0
    u[1::17] = 1.0 - 2.0 ** -23
    return c, isg, u


@pytest.mark.parametrize("windows", SPLIT_WINDOWS,
                         ids=lambda ws: f"w{ws[0]}-{ws[-1]}")
def test_split_draw_is_the_sequential_draw(windows):
    for window in windows:
        c, isg, u = _split_rows(window, window)
        z, logz = klein_cuda._draw_row_plain(c, isg, u, window)
        zs, lzs = _split_draw(c, isg, u, window)
        assert torch.equal(zs, z), window
        assert torch.equal(lzs, logz), window
        # u = 0 takes the window's first point; the largest uniform its last
        # wherever the last weight is not below 2^-23 of the total
        assert torch.equal(zs[::17], torch.round(c[::17]) - window // 2)


@pytest.mark.parametrize("windows", SPLIT_WINDOWS,
                         ids=lambda ws: f"w{ws[0]}-{ws[-1]}")
def test_split_draw_at_targets_on_segment_ends(windows):
    """u total landing exactly on a CDF value, the end of each segment of
    the window in turn and the points around it: the split draw counts
    the crossing where the sequential one does."""
    for window in windows:
        c, isg, _ = _split_rows(window, window + 7)
        base = torch.round(c)
        a = isg * isg
        w = klein_cuda._window_weights_plain((-a) * (base - c), a, window)
        run, rows = torch.zeros_like(c), []
        for k in range(window):
            run = run + w[k]
            rows.append(run)
        cdf = torch.stack(rows)
        total = cdf[-1]
        lo = window // 2
        ends = sorted({lo - 1 - SEG * q for q in range(-(-lo // SEG))}
                      | {lo + SEG * q - 1 for q in range(1, -(-(window - lo)
                                                               // SEG) + 1)})
        # the last segment's end is the total, which u total never reaches;
        # at 1,024 every fifth end
        ends = [k for k in ends if 0 <= k < window - 1]
        ends = ends[::-(-len(ends) // 26)]

        def sequential(u):
            idx = (cdf < u * total).sum(0).clamp(max=window - 1)
            return base + (idx - lo).to(c.dtype)

        _, logz = klein_cuda._draw_row_plain(c, isg, torch.rand_like(c),
                                             window)
        for k in ends:
            want = cdf[k]
            u0 = (want / total).float().view(torch.int32)
            u = u0.view(torch.float32)
            for d in (1, -1, 2, -2, 3, -3):
                # u a few ulps away where that product lands on the CDF
                alt = (u0 + d).view(torch.float32)
                u = torch.where((u * total == want) | (alt * total != want),
                                u, alt)
            u = u.clamp(0.0, 1.0 - 2.0 ** -23)
            zs, lzs = _split_draw(c, isg, u, window)
            assert torch.equal(zs, sequential(u)), (window, k)
            assert torch.equal(lzs, logz), (window, k)
            # (where the CDF has reached the total before k, no u does)
            assert bool(((u * total) == want).any()), (window, k)
            for d in (-1, 1):
                # and the uniforms an ulp either side
                v = (u.view(torch.int32) + d).view(torch.float32).clamp(
                    0.0, 1.0 - 2.0 ** -23)
                assert torch.equal(_split_draw(c, isg, v, window)[0],
                                   sequential(v))


RUNTIME_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_114imhk_tc_kernelILi0ELb0ELb0EEEvv
        /*0000*/                   MOV R1, R2 ;
.L_x_{a}:
        /*0010*/                   FADD R3, R3, R4 ;
.L_x_{b}:
        /*0020*/                   MUFU.EX2 R5, R5 ;
        /*0030*/                   FMUL R5, R5, R6 ;
        /*0040*/               @P0 BRA `(.L_x_{b}) ;
        /*0050*/               @P1 BRA `(.L_x_{c}) ;
        /*0060*/                   FMUL R7, R7, R7 ;
        /*0070*/                   {op} R7, R7, R7 ;
.L_x_{c}:
        /*0080*/                   MUFU.LG2 R8, R8 ;
        /*0090*/              @!P2 BRA `(.L_x_{a}) ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
\t\tFunction : probe_store
        /*0000*/                   EXIT ;
"""


def test_sass_runtime_loop_counts_segment_loops_by_trips():
    """The row loop of a W 0 kernel is the smallest loop holding a loop with
    an exp; its instructions are counted with the inner loop `trips` times,
    4 + 3 trips on the path that takes the forward branch and 6 + 3 trips
    on the one that does not, over the rows it draws."""
    listing = RUNTIME_LISTING.format(a=1, b=2, c=3, op="FMUL")
    name = sass.function_name(listing, "imhk_tc_kernelILi0ELb0ELb0E")
    got = sass.runtime_draw_loop(listing, name, 6, 2)
    assert got == {"trips": 6, "rows": 2, "instructions_low": 22,
                   "instructions_high": 24, "per_row_low": 11.0,
                   "per_row_high": 12.0,
                   "inner_loops": [{"instructions": 3, "ex2": 1}]}
    assert sass.runtime_draw_loop(listing, name, 2, 1)["per_row_low"] == 10
    with pytest.raises(ValueError):
        sass.runtime_draw_loop(listing, "probe_store", 6, 1)


def test_sass_function_digest_ignores_label_numbers():
    one = RUNTIME_LISTING.format(a=1, b=2, c=3, op="FMUL")
    other = RUNTIME_LISTING.format(a=40, b=41, c=45, op="FMUL")
    changed = RUNTIME_LISTING.format(a=1, b=2, c=3, op="FADD")
    name = sass.functions(one)[0]
    assert sass.functions(one) == [name, "probe_store"]
    digest = sass.function_digest(one, name)
    assert sass.function_digest(other, name) == digest
    assert sass.function_digest(changed, name) != digest
    # one kernel built from two checkouts: the same name less the hash
    mangled = ("_ZN43_GLOBAL__N__{}_10_imhk_tc_cu_41983f4814imhk_tc_kernel"
               "ILi16ELb0ELb0EEEvv")
    assert sass.stable_name(mangled.format("0d84fb6b")) == \
        sass.stable_name(mangled.format("b16c586b")) != mangled
