"""Klein draw (B1) and its ring (B6), fused IMHK steps (B2), the IMHK
trajectory (B3) and batched Babai decoding (B7) on Hopper: wrappers of the
CUDA kernels in `csrc/klein_tc.cu` (B1, B6, B7), `csrc/imhk_tc.cu` (B2,
B3) and `csrc/klein.cu` (B1, B6 and B7 above `KLEIN_TC_MAX_N_PAD`), their
plain PyTorch versions and the operand preparation.

Replaces the draw, ring, fused-MH and trajectory modes of the Pallas kernel
`lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py` `_kernel`
(`klein_sample_batch_pallas`, `klein_sample_ring_pallas`,
`imhk_step_pallas_fused`, `imhk_steps_batch_pallas`,
`imhk_trajectory_pallas`) and `babai_decode_batch_pallas`.

Layout. The kernel layout is chain-minor: the state is y (n_pad, B), so one
thread per chain reads and writes whole rows coalesced. n_pad is n rounded
up to 128 (padded rows: U = I, sigma = 1e-6, cs = 0, so they draw 0 with
log Z = 0). The chain state is the recentered integer vector y = x - k with
k = round(cs); the kernel's centre absorbs the shift,
cs_eff = cs - U k, computed once per call outside the kernel.

Centred B1 (`klein_draw_centred`, the FALCON signer's draw) is B1 with a
centre per chain: the caller recentres each chain on an integer point x0
of its own and passes the residual centres (n_pad, B) in the place of
cs_eff; x = x0 + y. Its in-kernel Philox gives the midpoint uniform
(`utils/prng.py` `philox_midpoint`), which never takes the window's first
point as k = 0 does.

B1, B2, B3 and B6 form the coupling on the tensor cores from an exact bf16
split of the float32 U (U = U1 + U2 + U3, `split_bf16`), packed in the mma
A-fragment order (`tc_fragments`). Their products are exact only while the
draw's recentred coefficients are: |y| <= 256 (hazard C8). The kernels
count the draws beyond that into their row of an `ExactGuard`
(`launch_record.py`); the wrapper, or the entry point that passed it one,
raises before it returns. B1 and B6 keep the draw in shared memory, which
bounds n_pad by `KLEIN_TC_MAX_N_PAD`:
above it, or where a window they do not compile leaves no room for its
draw's store, they take the FP32 sweep of `csrc/klein.cu` (`klein_route`,
by n_pad and window, before the launch). B2 and B3 keep the proposal in a device-memory
scratch (`proposal_scratch`), so that eight blocks share an SM, and hold
the same limit, `IMHK_TC_MAX_N_PAD`: above it they raise. B7 is the same sweep
with rounding in place of the draw and takes the same route; its
coefficients are not bounded by 256, so the kernel also multiplies U into
y's second and third bf16 parts where some |y| > 256, and decodes exactly
for any |y| < 2^24 (`babai_decode`).

Uniforms. Either the caller passes them (draw mode: row i = coordinate i,
shape (n_pad, B); ring mode: n_pad rows per round, round r in rows
r n_pad ..; fused mode: n_pad + 8 rows per step, the accept uniform
in row s (n_pad + 8) + n_pad — the Pallas kernel's host-uniform layout;
trajectory mode as fused mode), or
the kernel draws Philox4x32-10 uniforms keyed by (seed, chain id, step,
row), the same function as `utils/prng.py`.

Dispatch. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    check_cuda,
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    EXACT_Y,
    ExactGuard,
    count,
    device_counters,
    read_device_counters,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    TAG_ROW,
    chain_ids,
    philox_midpoint,
    philox_uniform,
    seed_key,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from lattice_gaussian_mcmc_tpu_torch.samplers.klein import KleinPrecomp

BLOCK = 128        # n is padded to a multiple of this
ROW_BLOCK = 64     # rows per block of the backward substitution
ACCEPT_ROWS = 8    # host-uniform rows per fused step beyond n_pad
# predicted standard deviations of a coefficient that `wide_y` covers
WIDE_TAIL = 7.0
WIDE_Y = 1 << 24   # |y| below which the WIDE instantiations are exact (C15)
# centred B1's contract: each chain's draw has its mean, U^-1 centres[:, b],
# within this of 0 in every coordinate (the signer's x0 = round(B^-1 t))
CENTRED_MEAN = 0.5
# the largest n_pad whose draw tile fits one block's shared memory:
# imhk_tc_common.cuh's tc_smem_bytes, 64 n_pad + 9,344 bytes, within the
# 227 KB (232,448 bytes) a block of sm_90 may take, rounded down to a
# multiple of 128
KLEIN_TC_MAX_N_PAD = 3456
# B2 and B3 hold B1's limit: B1 starts their chains, and no larger n_pad
# has been checked on the card
IMHK_TC_MAX_N_PAD = KLEIN_TC_MAX_N_PAD
TC_CHAINS = 32     # chains a block of the tensor-core sweeps (NC)
# the windows B1, B2, B3 and B6 compile (klein_tc.cu, imhk_tc.cu), and
# centred B1's; any other takes their W 0 instantiation, whose draw keeps
# floats a chain for each segment of a side in shared memory
# (imhk_tc_common.cuh `split_bytes`)
TC_WINDOWS = (8, 16, 24)
CENTRED_WINDOW = 40
TC_BLOCK_SMEM = 232448   # the shared memory a block of sm_90 may take


@dataclasses.dataclass
class KleinOperands:
    """Kernel operands of one precomputation, in the working dtype.

      U:     (n_pad, n_pad) unit-diagonal upper-triangular, row-major.
      UT:    U transposed, contiguous (the kernel's cross-block product
             reads a column of U as contiguous memory).
      cs:    (n_pad,) recentered centre cs_eff = cs - U k.
      isg:   (n_pad,) inverse conditional widths 1 / sigma_i.
      shift: (n_pad,) the integer recentering k = round(cs).
      n:     the lattice dimension before padding.
    """

    U: torch.Tensor
    UT: torch.Tensor
    cs: torch.Tensor
    isg: torch.Tensor
    shift: torch.Tensor
    n: int
    window: int

    @property
    def n_pad(self) -> int:
        return self.U.shape[0]

    @property
    def device(self) -> torch.device:
        return self.U.device


def split_bf16(U: torch.Tensor):
    """(U1, U2, U3) in bfloat16 with U1 + U2 + U3 = U: U1 = bf16(U),
    U2 = bf16(U - U1), U3 = bf16(U - U1 - U2), the residuals formed in
    float64. For a float32 U the sum is exact (24 bits in three 8-bit
    parts)."""
    r = U.to(torch.float64)
    parts = []
    for _ in range(3):
        p = r.to(torch.bfloat16)
        parts.append(p)
        r = r - p.to(torch.float64)
    return tuple(parts)


def _fragment_index(device):
    """Rows and columns (32, 8) of a 16 x 16 tile that lane l holds as
    registers a0..a7 of mma.sync m16n8k16's A operand: g = l / 4,
    t = l % 4, (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), then the same
    at columns + 8."""
    lane = torch.arange(32, device=device)
    g, t = lane // 4, 2 * (lane % 4)
    rows = torch.stack([g, g, g + 8, g + 8] * 2, dim=1)
    cols = torch.stack([t, t + 1, t, t + 1, t + 8, t + 9, t + 8, t + 9],
                       dim=1)
    return rows, cols


def fragment_pack(parts) -> torch.Tensor:
    """(n_pad, n_pad) bf16 parts -> (n_pad/16, n_pad/16, len(parts), 32, 8):
    entry [mt, kt, p, lane] is lane's A fragment of part p's tile (rows
    16 mt .., columns 16 kt ..), one 16-byte load per lane."""
    n_pad = parts[0].shape[0]
    mt = n_pad // 16
    rows, cols = _fragment_index(parts[0].device)
    tiles = [p.reshape(mt, 16, mt, 16).permute(0, 2, 1, 3)[:, :, rows, cols]
             for p in parts]
    return torch.stack(tiles, dim=2).contiguous()


def tc_fragments(ops) -> torch.Tensor:
    """The coupling operand of B1/B2/B3/B6 (`KleinOperands`), B4
    (`smk_cuda.SMKOperands`) and B7 (`BabaiOperands`), (n_pad/16, n_pad/16,
    3, 32, 8) bfloat16:
    `fragment_pack(split_bf16(ops.U))`, built at the first call and kept on
    `ops`."""
    frag = getattr(ops, "_tc_fragments", None)
    if frag is None:
        with span("lgm.operands.fragments"):
            frag = fragment_pack(split_bf16(ops.U))
        ops._tc_fragments = frag
    return frag


def _pad_precomp(pre: KleinPrecomp, block: int = BLOCK):
    """Pad U/cs/sigmas so n is a multiple of `block`. Padded rows get U = I,
    sigma = 1e-6 and cs = 0, so they draw 0 with log Z = 0 and never touch
    the real rows (the off-diagonal padding of U is zero).
    Returns (padded precomp, n)."""
    n, pad = pre.n, (-pre.n) % block
    if pad == 0:
        return pre, n
    U = torch.block_diag(pre.U, torch.eye(pad, dtype=pre.U.dtype,
                                          device=pre.device))
    return dataclasses.replace(
        pre, U=U, cs=F.pad(pre.cs, (0, pad)),
        sigmas=F.pad(pre.sigmas, (0, pad), value=1e-6)), n


def kernel_operands(pre: KleinPrecomp, dtype=torch.float32) -> KleinOperands:
    """Pad to 128 rows and recenter: k = round(cs) (half to even),
    cs_eff = cs - U k in float64 then cast, isg = 1 / sigma_i."""
    with span("lgm.setup.operands"):
        ppre, n_real = _pad_precomp(pre)
        U64 = ppre.U.to(torch.float64)
        cs64 = ppre.cs.to(torch.float64)
        k = torch.round(cs64)
        cs_eff = cs64 - U64 @ k
        U = U64.to(dtype).contiguous()
        return KleinOperands(
            U=U, UT=U.T.contiguous(), cs=cs_eff.to(dtype),
            isg=(1.0 / ppre.sigmas.to(torch.float64)).to(dtype),
            shift=k.to(dtype), n=n_real, window=ppre.window)


def predicted_y(ops: KleinOperands) -> float:
    """The largest |y| draws on `ops` are predicted to reach. A Klein
    draw's recentred coefficients are about y = U^-1 (cs + z), z_i ~ N(0,
    sigma_i^2); the prediction is max_i |mean_i| + WIDE_TAIL std_i +
    window / 2, in float64. It is kept on `ops` with the versions of U, cs
    and isg, and made again once any of them was changed in place."""
    key = (ops.U._version, ops.cs._version, ops.isg._version)
    kept = getattr(ops, "_predicted_y", None)
    if kept is None or kept[0] != key:
        with span("lgm.setup.operands"):
            n = ops.n
            U = ops.U[:n, :n].to(torch.float64)
            eye = torch.eye(n, dtype=torch.float64, device=U.device)
            Ui = torch.linalg.solve_triangular(U, eye, upper=True)
            sig = 1.0 / ops.isg[:n].to(torch.float64)
            mean = Ui @ ops.cs[:n].to(torch.float64)
            std = torch.sqrt((Ui * Ui) @ (sig * sig))
            top = float((mean.abs() + WIDE_TAIL * std).max())
            kept = (key, top + ops.window / 2)
            ops._predicted_y = kept
    return kept[1]


def wide_y(ops: KleinOperands) -> bool:
    """Whether draws on `ops` are predicted (`predicted_y`) to pass EXACT_Y
    (fault C11), so that B1, B2 and B6 take their WIDE instantiations,
    which carry y's second and third bf16 parts. The LLL-reduced q-ary
    basis of the suite's n = 64 row predicts ~2,800 (std up to ~400);
    NTRU-512 at FALCON's sigma stays far below 256. A draw beyond the
    prediction on the narrow instantiation still raises (hazard C8)."""
    return predicted_y(ops) > EXACT_Y


def _wide_span(wide: bool):
    """The span `lgm.route.wide` around a launch that `wide_y` sent to a
    WIDE instantiation (its device time falls under it), else nothing."""
    return span("lgm.route.wide") if wide else contextlib.nullcontext()


def check_reach(ops: KleinOperands, what: str):
    """Hazard C15: the WIDE instantiations carry |y| < WIDE_Y exactly and
    count nothing beyond, so B1, B2, B3 and B6 raise before any launch on
    operands whose `predicted_y` reaches WIDE_Y (or is not finite)."""
    top = predicted_y(ops)
    if not top < WIDE_Y:
        raise ValueError(
            f"{what}: draws on these operands are predicted to reach |y| "
            f"{top:.4g}, at or past 2^24 = {WIDE_Y}, the largest the "
            "kernels carry exactly (hazard C15)")


def to_kernel_layout(ops: KleinOperands, coeffs: torch.Tensor) -> torch.Tensor:
    """(B, n) integer coefficients -> recentered chain-minor (n_pad, B)."""
    B = coeffs.shape[0]
    y = torch.zeros(ops.n_pad, B, dtype=ops.U.dtype, device=ops.device)
    y[:ops.n] = coeffs.T.to(ops.U.dtype) - ops.shift[:ops.n, None]
    return y


def from_kernel_layout(ops: KleinOperands, y: torch.Tensor) -> torch.Tensor:
    """Recentered chain-minor (n_pad, B) -> (B, n) integer coefficients."""
    return (y[:ops.n] + ops.shift[:ops.n, None]).T.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the kernel's arithmetic, any device and dtype.
# ---------------------------------------------------------------------------


SEGMENT = 8        # weights a segment of the window (klein_common.cuh SEG)


@functools.lru_cache(maxsize=None)
def window_segments(window: int) -> tuple:
    """The segments of a window's offsets -W//2 .. W - W//2 - 1, as
    klein_common.cuh walks them: ((anchor, last), ...) in ascending order,
    [0, 7], [8, 15], ... above the centre and [-1, -8], [-9, -16], ...
    below it, each from its anchor, the offset nearest 0, to its last
    offset away from the centre; the window's edge may cut the outermost
    segments short."""
    lo, hi = window // 2, window - window // 2
    down = [(-1 - a, -min(a + SEGMENT, lo)) for a in range(0, lo, SEGMENT)]
    up = [(a, min(a + SEGMENT, hi) - 1) for a in range(0, hi, SEGMENT)]
    return tuple(down[::-1] + up)


@functools.lru_cache(maxsize=None)
def _segment_tables(window: int, dtype, device):
    """Per segment (anchor, anchor^2 / 2, its direction +-1, |anchor| +
    1/2, whether it is the anchor -1) as (S,) tensors, and each offset's
    (step from its anchor, segment)."""
    segs = window_segments(window)
    anc = [a for a, _ in segs]
    sgn = [-1.0 if a < 0 else 1.0 for a, _ in segs]
    t = torch.tensor

    def col(v):
        return t(v, dtype=dtype, device=device)

    step, seg = [], []
    for s, (a, last) in enumerate(segs):
        n = abs(last - a) + 1
        order = range(n - 1, -1, -1) if sgn[s] < 0 else range(n)
        step += list(order)
        seg += [s] * n
    return (col(anc), col([0.5 * a * a for a in anc]), col(sgn),
            col([abs(a) + 0.5 for a in anc]),
            t([a == -1 for a in anc], device=device),
            t(step, device=device), t(seg, device=device))


def _window_weights_plain(nad, a, window):
    """The window's weights (W, *nad.shape) in ascending order of offset,
    as the kernels compute them (klein_common.cuh): each segment of
    `window_segments` from its anchor's weight exp(off nad + (off^2/2)(-a))
    and first ratio exp(d nad + (|off| + 1/2)(-a)) (w(0) = 1; below the
    centre, w(-1) e), walked away from the centre by w = w rho, then
    rho = rho e, e = exp(-a), all in the dtype of nad."""
    anc, anch, sgn, dist, at1, step, seg = _segment_tables(
        window, nad.dtype, nad.device)
    shape = (-1,) + (1,) * nad.dim()
    anc, anch, sgn, dist, at1 = (v.reshape(shape)
                                 for v in (anc, anch, sgn, dist, at1))
    e = torch.exp(-a)
    w = torch.exp(anc * nad + anch * (-a))      # w(0) = exp(0) = 1
    rho = torch.where(at1, w * e, torch.exp(sgn * nad + dist * (-a)))
    walk = [w]
    for _ in range(1, min(SEGMENT, window - window // 2)):
        w = w * rho
        rho = rho * e
        walk.append(w)
    return torch.stack(walk)[step, seg]


def _draw_row_plain(c, isg, u, window):
    """Windowed inverse-CDF draw around centres c (B,) with the kernel's
    arithmetic: unnormalised weights exp(-a (off^2/2 + delta off)),
    a = isg^2, by `_window_weights_plain`, a sequential prefix sum for the
    CDF, idx = #{k : cdf_k < u total}. Returns (z, log Z) with
    log Z = m + log(total)."""
    base = torch.round(c)
    delta = base - c
    a = isg * isg
    nad = (-a) * delta
    m = (-0.5 * a) * (delta * delta)
    w = _window_weights_plain(nad, a, window)              # (W, B)
    cdf = torch.empty_like(w)
    run = torch.zeros_like(c)
    for k in range(window):
        run = run + w[k]
        cdf[k] = run
    idx = torch.sum(cdf < u * run, dim=0).clamp_(max=window - 1)
    z = base + (idx - window // 2).to(c.dtype)
    return z, m + torch.log(run)


def _propose_plain(ops: KleinOperands, rows, out: torch.Tensor,
                   centres=None, cs=None) -> torch.Tensor:
    """One Klein draw into out (n_pad, B): backward substitution over 64-row
    blocks (cross-block product, then rows in descending order); rows(lo, hi)
    gives the uniforms of coordinates lo..hi-1. Returns lw (B,), summed in
    float64. With `centres` (n_pad, B), row i's conditional centre goes to
    centres[i]. With `cs` (n_pad, B), chain b is drawn around cs[:, b] in
    place of ops.cs.

    The padded rows i >= n are left at the 0 that `out` holds: in the
    kernel their centre is exactly 0 and their width 1e-6, so they draw 0
    with log Z = 0 (only a uniform of exactly 0 would put -W/2 there, in a
    row that couples to nothing and is dropped from the output)."""
    n_pad, B = out.shape
    dt, dev = ops.U.dtype, ops.device
    lw = torch.zeros(B, dtype=torch.float64, device=dev)
    for lo in range(n_pad - ROW_BLOCK, -1, -ROW_BLOCK):
        hi = lo + ROW_BLOCK
        if lo >= ops.n:
            continue
        t = ops.U[lo:hi, hi:] @ out[hi:]
        u = rows(lo, min(hi, ops.n)).to(dt)
        for r in range(min(ROW_BLOCK, ops.n - lo) - 1, -1, -1):
            i = lo + r
            c = ((ops.cs[i] if cs is None else cs[i]) - t[r]
                 - ops.U[i, i + 1:hi] @ out[i + 1:hi])
            if centres is not None:
                centres[i] = c
            z, logz = _draw_row_plain(c, ops.isg[i], u[r], ops.window)
            out[i] = z
            lw += logz.to(torch.float64)
    return lw.to(dt)


def _uniform_rows(ops, B, seed, step, chain_offset, uniforms=None, row0=0,
                  midpoint=False):
    """rows(lo, hi): the uniforms of coordinates lo..hi-1, from the host
    tensor (its rows row0 + lo ..) or from Philox (its midpoint uniforms
    with `midpoint`), one row block at a time so that the plain version
    never holds all n x B counters."""
    if uniforms is not None:
        return lambda lo, hi: uniforms[row0 + lo:row0 + hi]
    chains = chain_ids(B, chain_offset, ops.device)
    philox = philox_midpoint if midpoint else philox_uniform
    return lambda lo, hi: philox(
        seed, chains, step, torch.arange(lo, hi, device=ops.device), TAG_ROW)


def klein_draw_plain(ops: KleinOperands, num_chains: int, *, seed: int = 0,
                     step: int = 0, chain_offset: int = 0, uniforms=None):
    """Plain version of B1 (B6's with one round): returns (y (n_pad, B),
    lw (B,))."""
    y, lw = klein_ring_plain(ops, num_chains, 1, seed=seed, step=step,
                             chain_offset=chain_offset, uniforms=uniforms)
    return y, lw[0]


def klein_draw_centred_plain(ops: KleinOperands, centres: torch.Tensor, *,
                             seed: int = 0, step: int = 0,
                             chain_offset: int = 0, uniforms=None):
    """Plain version of centred B1: one draw per chain b around its own
    recentred centres centres[:, b] (n_pad, B), in place of ops.cs, on
    Philox's midpoint uniforms or the caller's. Returns (y (n_pad, B),
    lw (B,))."""
    B = centres.shape[1]
    y = torch.zeros(ops.n_pad, B, dtype=ops.U.dtype, device=ops.device)
    rows = _uniform_rows(ops, B, seed, step, chain_offset, uniforms,
                         midpoint=True)
    lw = _propose_plain(ops, rows, y, cs=centres.to(ops.U.dtype))
    return y, lw


def klein_ring_plain(ops: KleinOperands, num_chains: int, n_rounds: int, *,
                     seed: int = 0, step: int = 0, chain_offset: int = 0,
                     uniforms=None, centres=None):
    """Plain version of B6: n_rounds B1 draws per chain, round r at Philox
    step `step + r` (host uniform rows r n_pad ..). Returns the ring
    (n_rounds n_pad, B) and the lw ring (n_rounds, B). With `centres`
    (n_rounds n_pad, B), each row's conditional centre goes there."""
    n_pad = ops.n_pad
    ring = torch.zeros(n_rounds * n_pad, num_chains, dtype=ops.U.dtype,
                       device=ops.device)
    lws = torch.empty(n_rounds, num_chains, dtype=ops.U.dtype,
                      device=ops.device)
    for r in range(n_rounds):
        rows = _uniform_rows(ops, num_chains, seed, step + r, chain_offset,
                             uniforms, r * n_pad)
        sl = slice(r * n_pad, (r + 1) * n_pad)
        lws[r] = _propose_plain(ops, rows, ring[sl],
                                None if centres is None else centres[sl])
    return ring, lws


def ring_coeffs(ops: KleinOperands, ring: torch.Tensor) -> torch.Tensor:
    """B6's ring (n_rounds n_pad, B) -> (n_rounds, B, n) integer
    coefficients."""
    n_rounds = ring.shape[0] // ops.n_pad
    y = ring.reshape(n_rounds, ops.n_pad, -1)[:, :ops.n]
    return (y + ops.shift[None, :ops.n, None]).transpose(1, 2)


def imhk_fused_plain(ops: KleinOperands, x, lw, acc, n_steps: int, *,
                     seed: int = 0, step: int = 0, chain_offset: int = 0,
                     uniforms=None, tlw=None, tx=None, thin: int = 1,
                     centres=None, proposal=None):
    """Plain version of B2: n_steps IMHK steps updating the chain-minor
    state x (n_pad, B), lw (B,) and the acceptance count acc (B,) in place.
    Step s uses Philox step `step + s`. With a ring (B3's plain version,
    `imhk_trajectory_plain`), after step s with (s + 1) % thin == 0 the lw
    goes to tlw[(s + 1) / thin - 1] and, when tx is given, the state to
    that keep's n_pad rows of tx. With `centres` and `proposal` (n_pad, B),
    the last step's conditional centres and proposal go there. Returns
    (x, lw, acc)."""
    n_pad, B = x.shape
    dt, dev = ops.U.dtype, ops.device
    prop = torch.zeros_like(x) if proposal is None else proposal
    rows_per_step = n_pad + ACCEPT_ROWS
    for s in range(n_steps):
        rows = _uniform_rows(ops, B, seed, step + s, chain_offset, uniforms,
                             s * rows_per_step)
        if uniforms is not None:
            ua = uniforms[s * rows_per_step + n_pad]
        else:
            ua = philox_uniform(seed, chain_ids(B, chain_offset, dev),
                                step + s, torch.zeros(1, device=dev),
                                TAG_ACCEPT)[0]
        lwp = _propose_plain(ops, rows, prop, centres)
        ua = torch.clamp(ua.to(dt), min=1e-30)
        accept = torch.log(ua) < (lwp - lw)
        x.copy_(torch.where(accept[None, :], prop, x))
        lw.copy_(torch.where(accept, lwp, lw))
        acc += accept.to(acc.dtype)
        if tlw is not None and (s + 1) % thin == 0:
            k = (s + 1) // thin - 1
            tlw[k] = lw
            if tx is not None:
                tx[k * n_pad:(k + 1) * n_pad] = x
    return x, lw, acc


def _trajectory_ring(x, n_keep: int, coeffs: bool):
    n_pad, B = x.shape
    tlw = torch.zeros(n_keep, B, dtype=x.dtype, device=x.device)
    tx = (torch.zeros(n_keep * n_pad, B, dtype=x.dtype, device=x.device)
          if coeffs else None)
    return tlw, tx


def imhk_trajectory_plain(ops: KleinOperands, x, lw, acc, n_keep: int,
                          thin: int = 1, *, seed: int = 0, step: int = 0,
                          chain_offset: int = 0, uniforms=None,
                          coeffs: bool = False):
    """Plain version of B3: n_keep * thin IMHK steps (B2's plain version,
    state in place) keeping every thin-th state. Returns
    (x, lw, acc, tx (n_keep * n_pad, B) or None, tlw (n_keep, B))."""
    tlw, tx = _trajectory_ring(x, n_keep, coeffs)
    imhk_fused_plain(ops, x, lw, acc, n_keep * thin, seed=seed, step=step,
                     chain_offset=chain_offset, uniforms=uniforms, tlw=tlw,
                     tx=tx, thin=thin)
    return x, lw, acc, tx, tlw


def trajectory_coeffs(ops: KleinOperands, tx: torch.Tensor) -> torch.Tensor:
    """Coefficient ring (n_keep * n_pad, B) -> chain-major (B * n_keep, n)
    integer coefficients (chain b's keeps in rows b n_keep ..)."""
    n_keep = tx.shape[0] // ops.n_pad
    B = tx.shape[1]
    y = tx.reshape(n_keep, ops.n_pad, B)[:, :ops.n]
    X = y + ops.shift[None, :ops.n, None]
    return X.permute(2, 0, 1).reshape(B * n_keep, ops.n)


# ---------------------------------------------------------------------------
# Babai nearest plane (B7): operands, recentring and the plain version.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BabaiOperands:
    """Operands of batched Babai decoding on one lattice.

      U, UT:  (n_pad, n_pad) unit upper-triangular R / diag(R), padded to
              128 rows with the identity, and its transpose, in the
              working dtype (float32 for the kernel).
      Q:      (n, n) the lattice's Q in float64.
      U64:    (n, n) R / diag(R) in float64 (the recentring product).
      r_diag: (n,) diag(R) in float64.
      n:      the lattice dimension before padding.
    """

    U: torch.Tensor
    UT: torch.Tensor
    Q: torch.Tensor
    U64: torch.Tensor
    r_diag: torch.Tensor
    n: int

    @property
    def n_pad(self) -> int:
        return self.U.shape[0]

    @property
    def device(self) -> torch.device:
        return self.U.device


def babai_operands(Q, R, dtype=torch.float32) -> BabaiOperands:
    """B7's operands from a lattice's Q and R (on their device)."""
    with span("lgm.operands.babai"):
        Q64, R64 = Q.to(torch.float64), R.to(torch.float64)
        n = R64.shape[0]
        r_diag = torch.diagonal(R64).clone()
        U64 = R64 / r_diag[:, None]
        n_pad = -(-n // BLOCK) * BLOCK
        U = torch.eye(n_pad, dtype=torch.float64, device=R.device)
        U[:n, :n] = U64
        U = U.to(dtype).contiguous()
        return BabaiOperands(U=U, UT=U.T.contiguous(), Q=Q64, U64=U64,
                             r_diag=r_diag, n=n)


def babai_centres(ops: BabaiOperands, targets: torch.Tensor):
    """Per-target centres of targets (B, n): ct = (t Q) / diag(R) in
    float64 from the lattice's own Q and R (hazard C7), recentred by
    `babai_recentre`."""
    with span("lgm.layout.centres"):
        ct = (targets.to(torch.float64) @ ops.Q) / ops.r_diag
    return babai_recentre(ops, ct)


def babai_recentre(ops: BabaiOperands, ct: torch.Tensor):
    """Recentre the centres ct (B, n) in float64, then cast to the working
    dtype: k = round(ct), ct' = ct - U k. Returns (ct' (n_pad, B)
    chain-minor, k (B, n) float64)."""
    with span("lgm.layout.recentre"):
        ct = ct.to(torch.float64)
        k = torch.round(ct)
        centred = torch.zeros(ops.n_pad, ct.shape[0], dtype=ops.U.dtype,
                              device=ops.device)
        centred[:ops.n] = (ct - k @ ops.U64.T).T.to(ops.U.dtype)
        return centred, k


def babai_decode_plain(ops: BabaiOperands, ct: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 on recentred centres ct (n_pad, B): the backward
    substitution over 64-row blocks with round (half to even) in place of
    the draw. Returns y (n_pad, B), in the operands' dtype."""
    y = torch.zeros_like(ct)
    for lo in range(ops.n_pad - ROW_BLOCK, -1, -ROW_BLOCK):
        hi = lo + ROW_BLOCK
        if lo >= ops.n:
            continue
        t = ops.U[lo:hi, hi:] @ y[hi:]
        for r in range(min(ROW_BLOCK, ops.n - lo) - 1, -1, -1):
            i = lo + r
            c = ct[i] - t[r] - ops.U[i, i + 1:hi] @ y[i + 1:hi]
            y[i] = torch.round(c)
    return y


def babai_coeffs(ops: BabaiOperands, targets: torch.Tensor) -> torch.Tensor:
    """Nearest-plane coefficients (B, n) float64 of targets (B, n): B7 on a
    card, its plain version in the operands' dtype on the CPU."""
    centred, k = babai_centres(ops, targets)
    y = babai_decode(ops, centred)
    with span("lgm.layout.coeffs"):
        return y[:ops.n].T.to(torch.float64) + k


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_operands(ops: KleinOperands):
    n_pad = ops.n_pad
    if n_pad % BLOCK:
        raise ValueError(f"n_pad {n_pad} is not a multiple of {BLOCK}")
    check_cuda("U", ops.U, (n_pad, n_pad))
    check_cuda("UT", ops.UT, (n_pad, n_pad))
    for name in ("cs", "isg"):
        check_cuda(name, getattr(ops, name), (n_pad,))
    if not 1 <= ops.window <= 1024:
        raise ValueError(f"window {ops.window} outside [1, 1024]")


def runtime_window(window: int, compiled=TC_WINDOWS) -> bool:
    """Whether a launch at `window` takes the W 0 instantiation: a window
    the library does not compile (`TC_WINDOWS`; centred B1's is
    `CENTRED_WINDOW`)."""
    return window not in compiled


def _runtime_tc(route: str, window: int) -> bool:
    """A B1/B6 launch on `route` took the tensor-core sweep's W 0
    instantiation (klein.cu's sweep is counted apart, in `fp32_launches`)."""
    return route == "klein_tc" and runtime_window(window)


# floats a chain of the coupling tile that no row uses (imhk_tc_common.cuh
# CT_STRIDE - RB)
TILE_SPARE = 8


def split_bytes(window: int) -> int:
    """imhk_tc_common.cuh `split_bytes` as B1 and B6 take it (`lend`): the
    W 0 draw's store for a block of `TC_CHAINS` chains, for each segment of
    a side the upper thread's anchor (2 floats a chain) and, past
    `TILE_SPARE` segments, the lower thread's end CDF (1 float), which
    otherwise lives in the coupling tile."""
    steps = -(-(window - window // 2) // SEGMENT)
    return steps * TC_CHAINS * (2 if steps <= TILE_SPARE else 3) * 4


def klein_route(n_pad: int, window: int = TC_WINDOWS[0],
                compiled=TC_WINDOWS, wide: bool = False) -> str:
    """The kernel library B1 and B6 launch at n_pad and `window` (on their
    WIDE instantiation with `wide`): "klein_tc" (the tensor-core sweep,
    `csrc/klein_tc.cu`) up to `KLEIN_TC_MAX_N_PAD`, where its draw tile
    fits a block's shared memory, with, at a window outside `compiled`, the
    W 0 draw's store (`split_bytes`) after the tile, the coupling tile and
    WIDE's flags (klein_tc.cu `kernel_smem`); else "klein" (the FP32 sweep
    of `csrc/klein.cu`, no limit on n_pad). The default window is a
    compiled one, which needs no store (B7, which draws nothing, takes
    it)."""
    if n_pad > KLEIN_TC_MAX_N_PAD:
        return "klein"
    if runtime_window(window, compiled):
        own = 64 * n_pad + 9344 + (n_pad // 16 if wide else 0)
        if -(-own // 16) * 16 + split_bytes(window) > TC_BLOCK_SMEM:
            return "klein"
    return "klein_tc"


def _klein_launch(ops: KleinOperands, num_chains: int, n_rounds: int,
                  seed: int, step: int, chain_offset: int, uniforms,
                  what: str, bad=None, dbg=None):
    """Launch B1 (n_rounds 1) or B6 on the library `klein_route` picks;
    returns the ring (n_rounds n_pad, B), the lw ring (n_rounds, B), that
    library's name and whether the launch took the WIDE instantiation
    (`wide_y`). The tensor-core sweep counts C8 into bad (its row of an
    `ExactGuard`) and, with `dbg`, writes the centres there. Raises on bad
    input or a launch error; does not wait."""
    if n_rounds < 1:
        raise ValueError(f"n_rounds {n_rounds} must be >= 1")
    _check_operands(ops)
    check_reach(ops, what)
    n_pad = ops.n_pad
    if uniforms is not None:
        check_cuda("uniforms", uniforms, (n_rounds * n_pad, num_chains))
    ring = torch.empty(n_rounds * n_pad, num_chains, dtype=torch.float32,
                       device=ops.device)
    lws = torch.empty(n_rounds, num_chains, dtype=torch.float32,
                      device=ops.device)
    k0, k1 = seed_key(seed)
    unif = ptr(uniforms) if uniforms is not None else None
    stream = ctypes.c_void_p(
        torch.cuda.current_stream(ops.device).cuda_stream)
    wide = dbg is None and wide_y(ops)
    route = klein_route(n_pad, ops.window, wide=wide)
    if route == "klein_tc":
        check_cuda("bad", bad, (2,), torch.int32)
        lib, frag = load(route), tc_fragments(ops)
        with _wide_span(wide):
            rc = lib.klein_tc_launch(
                ptr(frag), ptr(ops.UT), ptr(ops.cs), ptr(ops.isg), unif,
                ptr(ring), ptr(lws), ptr(dbg) if dbg is not None else None,
                ptr(bad), n_pad, num_chains, ops.window, n_rounds, k0, k1,
                step, chain_offset, int(wide), stream)
    else:
        if dbg is not None:
            raise ValueError(f"{what}: the centres are written by the "
                             "tensor-core sweep only, n_pad <= "
                             f"{KLEIN_TC_MAX_N_PAD} (`klein_route`)")
        wide = False
        rc = load(route).klein_ring_launch(
            ptr(ops.U), ptr(ops.UT), ptr(ops.cs), ptr(ops.isg), unif,
            ptr(ring), ptr(lws), n_pad, num_chains, ops.window, n_rounds,
            k0, k1, step, chain_offset, stream)
    raise_on(route, rc, what)
    return ring, lws, route, wide


def klein_draw(ops: KleinOperands, num_chains: int, *, seed: int = 0,
               step: int = 0, chain_offset: int = 0, uniforms=None,
               guard=None):
    """B1: one Klein draw per chain. Returns (y (n_pad, B) recentered
    integer-valued, lw (B,)). With `guard` (an `ExactGuard`) the caller
    checks the C8 counters; without one the wrapper checks its own after
    the launch. CPU operands run `klein_draw_plain`."""
    with span("lgm.kernel.b1"):
        if ops.device.type == "cpu":
            return klein_draw_plain(ops, num_chains, seed=seed, step=step,
                                    chain_offset=chain_offset,
                                    uniforms=uniforms)
        own = guard is None
        if own:
            guard = ExactGuard(ops.device)
        y, lw, route, wide = _klein_launch(ops, num_chains, 1, seed, step,
                                           chain_offset, uniforms,
                                           "klein_draw",
                                           guard.row("klein_draw"))
        count("klein_draw", fp32=route != "klein_tc", wide=wide,
              runtime_window=_runtime_tc(route, ops.window))
        if own:
            guard.check("klein_draw")
        return y, lw[0]


def klein_draw_centred(ops: KleinOperands, centres: torch.Tensor, *,
                       seed: int = 0, step: int = 0, chain_offset: int = 0,
                       uniforms=None, guard=None):
    """Centred B1 (`klein_tc.cu`'s CENTRED instantiation): one Klein draw
    per chain b around its own recentred centres centres[:, b] (n_pad, B)
    float32, which take the place of ops.cs; padded rows must hold 0.
    Returns (y (n_pad, B), lw (B,)); the caller adds its integer points.

    The caller recentres each chain so that the mean of its draw, U^-1
    centres[:, b], lies within `CENTRED_MEAN` (1/2) of 0 in every
    coordinate, as the signer's x0 = round(B^-1 t) does. Draws then reach
    at most `predicted_y(ops)` + 1/2 (tight for operands at centre 0), which
    must stay within the narrow kernel's exact 256 (hazard C8; there is no
    WIDE instantiation) or the wrapper raises before the launch; a drawn
    |y| > 256 is counted into its row of `guard`. `guard` and the uniforms
    as for `klein_draw`; tensor-core sweep only (n_pad up to
    `KLEIN_TC_MAX_N_PAD`). Without `uniforms` the draw takes the midpoint
    uniforms of its Philox counters (`utils/prng.py` `philox_midpoint`), in
    place of B1's. CPU operands run `klein_draw_centred_plain`."""
    with span("lgm.kernel.b1"):
        if ops.device.type == "cpu":
            return klein_draw_centred_plain(
                ops, centres, seed=seed, step=step,
                chain_offset=chain_offset, uniforms=uniforms)
        _check_operands(ops)
        n_pad, B = ops.n_pad, centres.shape[1]
        check_cuda("centres", centres, (n_pad, B))
        if klein_route(n_pad, ops.window, (CENTRED_WINDOW,)) != "klein_tc":
            raise ValueError(
                f"klein_draw_centred: n_pad {n_pad} at window {ops.window} "
                "is past the tensor-core sweep's shared memory (n_pad up to "
                f"{KLEIN_TC_MAX_N_PAD}), the only route the centred draw "
                "takes")
        top = predicted_y(ops) + CENTRED_MEAN
        if not top <= EXACT_Y:
            raise ValueError(
                f"klein_draw_centred: draws around these centres are "
                f"predicted to reach |y| {top:.4g}, past {EXACT_Y}, where "
                "the narrow kernel's bf16 coupling is exact (hazard C8)")
        if uniforms is not None:
            check_cuda("uniforms", uniforms, (n_pad, B))
        own = guard is None
        if own:
            guard = ExactGuard(ops.device)
        y = torch.empty(n_pad, B, dtype=torch.float32, device=ops.device)
        lw = torch.empty(B, dtype=torch.float32, device=ops.device)
        k0, k1 = seed_key(seed)
        rc = load("klein_tc").klein_tc_centred_launch(
            ptr(tc_fragments(ops)), ptr(ops.UT), ptr(centres), ptr(ops.isg),
            ptr(uniforms) if uniforms is not None else None, ptr(y), ptr(lw),
            ptr(guard.row("klein_draw_centred")), n_pad, B, ops.window, k0,
            k1, step, chain_offset,
            ctypes.c_void_p(
                torch.cuda.current_stream(ops.device).cuda_stream))
        raise_on("klein_tc", rc, "klein_draw_centred")
        count("klein_draw_centred",
              runtime_window=runtime_window(ops.window, (CENTRED_WINDOW,)))
        if own:
            guard.check("klein_draw_centred")
        return y, lw


def klein_ring(ops: KleinOperands, num_chains: int, n_rounds: int, *,
               seed: int = 0, step: int = 0, chain_offset: int = 0,
               uniforms=None, guard=None):
    """B6: n_rounds independent Klein draws per chain in one launch, round r
    at Philox step `step + r`, written to a ring (n_rounds n_pad, B) of
    recentred coefficients and a ring (n_rounds, B) of lw. Round 0 is B1's
    draw on the same uniforms. `guard` as for `klein_draw`. CPU operands
    run `klein_ring_plain`."""
    if ops.device.type == "cpu":
        return klein_ring_plain(ops, num_chains, n_rounds, seed=seed,
                                step=step, chain_offset=chain_offset,
                                uniforms=uniforms)
    own = guard is None
    if own:
        guard = ExactGuard(ops.device)
    ring, lws, route, wide = _klein_launch(ops, num_chains, n_rounds, seed,
                                           step, chain_offset, uniforms,
                                           "klein_ring",
                                           guard.row("klein_ring"))
    count("klein_ring", fp32=route != "klein_tc", wide=wide,
          runtime_window=_runtime_tc(route, ops.window))
    if own:
        guard.check("klein_ring")
    return ring, lws


def klein_centres_plain(ops: KleinOperands, num_chains: int,
                        n_rounds: int = 1, *, seed: int = 0, step: int = 0,
                        chain_offset: int = 0, uniforms=None):
    """Plain version of `klein_centres`: B6's plain version that also
    returns each round's conditional centres."""
    centres = torch.zeros(n_rounds * ops.n_pad, num_chains,
                          dtype=ops.U.dtype, device=ops.device)
    ring, lws = klein_ring_plain(ops, num_chains, n_rounds, seed=seed,
                                 step=step, chain_offset=chain_offset,
                                 uniforms=uniforms, centres=centres)
    return centres, ring, lws


def klein_centres(ops: KleinOperands, num_chains: int, n_rounds: int = 1, *,
                  seed: int = 0, step: int = 0, chain_offset: int = 0,
                  uniforms=None):
    """B1/B6's debug instantiation (the tensor-core sweep, n_pad <=
    `KLEIN_TC_MAX_N_PAD`): n_rounds draws as `klein_ring` makes them that
    also write each row's conditional centre c_i as the kernel forms it.
    Returns (centres, ring), each (n_rounds n_pad, B) recentred, and the
    lw ring (n_rounds, B). For holding the kernel's own centres to float64;
    not a launch of the main path. CPU operands run
    `klein_centres_plain`."""
    if ops.device.type == "cpu":
        return klein_centres_plain(ops, num_chains, n_rounds, seed=seed,
                                   step=step, chain_offset=chain_offset,
                                   uniforms=uniforms)
    dbg = torch.empty(n_rounds * ops.n_pad, num_chains, dtype=torch.float32,
                      device=ops.device)
    guard = ExactGuard(ops.device)
    ring, lws, _, _ = _klein_launch(ops, num_chains, n_rounds, seed, step,
                                    chain_offset, uniforms, "klein_centres",
                                    guard.row("klein_ring"), dbg=dbg)
    guard.check("klein_centres")
    return dbg, ring, lws


# klein_tc.cu's kernel modes, as `klein_tc_info` numbers them
KLEIN_TC_MODES = {"b1": 0, "b6": 1, "b7": 2, "b1_wide": 3, "b6_wide": 4,
                  "b1_centred": 5}


def klein_tc_resources(n_pad: int, window: int, mode: str = "b1") -> dict:
    """`klein_tc.cu`'s kernel in `mode` ("b1", "b6", "b7", whose
    instantiation takes no window, the WIDE instantiations "b1_wide" and
    "b6_wide", or centred B1, "b1_centred") for `window` at n_pad on the
    current card: registers and local (spill) bytes a thread, dynamic
    shared memory and threads a block, and blocks resident per SM."""
    out = (ctypes.c_int * 5)()
    raise_on("klein_tc", load("klein_tc").klein_tc_info(
        n_pad, window, KLEIN_TC_MODES[mode], out), "klein_tc_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads"), list(out)))


def babai_decode(ops: BabaiOperands, ct: torch.Tensor) -> torch.Tensor:
    """B7: Babai nearest plane for every column of the recentred centres ct
    (n_pad, B) in one launch; returns y (n_pad, B). The library is
    `klein_route`'s: the tensor-core sweep up to `KLEIN_TC_MAX_N_PAD`
    (the record's `launches`), the FP32 sweep above (its
    `fp32_launches`). Both are exact in their operands for
    |y| < 2^24 and raise nothing; the launch adds to the device counters
    that `babai_y_stats` reads. CPU operands run `babai_decode_plain`."""
    with span("lgm.kernel.b7"):
        if ops.device.type == "cpu":
            return babai_decode_plain(ops, ct)
        n_pad, B = ops.n_pad, ct.shape[1]
        if n_pad % BLOCK:
            raise ValueError(f"n_pad {n_pad} is not a multiple of {BLOCK}")
        check_cuda("U", ops.U, (n_pad, n_pad))
        check_cuda("UT", ops.UT, (n_pad, n_pad))
        check_cuda("ct", ct, (n_pad, B))
        y = torch.empty_like(ct)
        bad = device_counters("babai_decode", ops.device, 2, torch.int32)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(ops.device).cuda_stream)
        route = klein_route(n_pad)
        if route == "klein_tc":
            rc = load(route).babai_tc_launch(
                ptr(tc_fragments(ops)), ptr(ops.UT), ptr(ct), ptr(y), ptr(bad),
                n_pad, B, stream)
        else:
            rc = load(route).babai_decode_launch(
                ptr(ops.U), ptr(ops.UT), ptr(ct), ptr(y), ptr(bad), n_pad, B,
                stream)
        raise_on(route, rc, "babai_decode")
        count("babai_decode", fp32=route != "klein_tc")
        return y


def babai_y_stats() -> dict:
    """B7's recentred coefficients since the last `launch_record.reset`,
    over both routes (one synchronisation): how many had |y| > 256 (decoded
    on y's wide parts), and the largest |y|."""
    rows = read_device_counters("babai_decode")
    return {"beyond_256": sum(r[0] for r in rows),
            "max_abs_y": max((r[1] for r in rows), default=0)}


def _imhk_tc_launch(ops: KleinOperands, x, lw, acc, n_steps: int, seed: int,
                    step: int, chain_offset: int, uniforms, what: str,
                    bad: torch.Tensor, tlw=None, tx=None, thin: int = 1,
                    dbg=None) -> tuple:
    """Launch imhk_tc.cu's kernel on x (n_pad, B), lw, acc in place, its C8
    counters into bad (its row of an `ExactGuard`); raise on a launch
    error. Does not wait for the kernel. Returns the chains resident an SM
    at the launch (`imhk_tc_residency`) and whether it took the WIDE
    instantiation (`wide_y`)."""
    _check_operands(ops)
    check_reach(ops, what)
    if ops.n_pad > IMHK_TC_MAX_N_PAD:
        raise ValueError(
            f"{what}: n_pad {ops.n_pad} is above {IMHK_TC_MAX_N_PAD}, the "
            "largest B2 and B3 take (B1's, which starts their chains)")
    B = x.shape[1]
    check_cuda("x", x, (ops.n_pad, B))
    check_cuda("lw", lw, (B,))
    check_cuda("acc", acc, (B,))
    check_cuda("bad", bad, (2,), torch.int32)
    if uniforms is not None:
        check_cuda("uniforms", uniforms,
                   (n_steps * (ops.n_pad + ACCEPT_ROWS), B))
    lib = load("imhk_tc")
    k0, k1 = seed_key(seed)
    wide = dbg is None and wide_y(ops)
    # the WIDE instantiation's float32 proposals (fault C11)
    yprop = torch.empty_like(x) if wide else None
    scratch = proposal_scratch(ops.n_pad, B, ops.device)
    frag = tc_fragments(ops)
    with _wide_span(wide):
        rc = lib.imhk_tc_launch(
            ptr(frag), ptr(ops.UT), ptr(ops.cs), ptr(ops.isg),
            ptr(uniforms) if uniforms is not None else None,
            ptr(x), ptr(lw), ptr(acc),
            ptr(tlw) if tlw is not None else None,
            ptr(tx) if tx is not None else None,
            ptr(dbg) if dbg is not None else None,
            ptr(yprop) if yprop is not None else None, ptr(scratch),
            ptr(bad), thin, ops.n_pad, B, ops.window, n_steps, k0, k1, step,
            chain_offset,
            ctypes.c_void_p(torch.cuda.current_stream(ops.device).cuda_stream))
    raise_on("imhk_tc", rc, what)
    return imhk_tc_residency(ops.n_pad, ops.window, wide, ops.device), wide


def proposal_scratch(n_pad: int, num_chains: int, device) -> torch.Tensor:
    """B2/B3's proposals in device memory: (blocks, n_pad, 32) bf16, one
    (n_pad, 32) region for each block of `TC_CHAINS` chains, in the layout
    the kernel gives it (chains swizzled within a row). The kernel writes it
    before it reads it; through the caching allocator a call reuses the
    last call's."""
    blocks = -(-num_chains // TC_CHAINS)
    return torch.empty(blocks, n_pad, TC_CHAINS, dtype=torch.bfloat16,
                       device=device)


def imhk_fused(ops: KleinOperands, x, lw, acc, n_steps: int, *,
               seed: int = 0, step: int = 0, chain_offset: int = 0,
               uniforms=None, guard=None):
    """B2: n_steps fused IMHK steps in one launch, updating x (n_pad, B),
    lw (B,) and acc (B,) (float32 acceptance counts) in place. The proposal
    goes to a device-memory scratch (`proposal_scratch`) that the kernel
    reads back through a ring in shared memory, so that eight blocks of 32
    chains share an SM (four for the WIDE instantiation); the record's
    `resident_chains` holds the chains an SM held at the last launch.
    `guard` as for `klein_draw`. CPU operands run `imhk_fused_plain`."""
    with span("lgm.kernel.b2"):
        if ops.device.type == "cpu":
            return imhk_fused_plain(ops, x, lw, acc, n_steps, seed=seed,
                                    step=step, chain_offset=chain_offset,
                                    uniforms=uniforms)
        own = guard is None
        if own:
            guard = ExactGuard(ops.device)
        resident, wide = _imhk_tc_launch(
            ops, x, lw, acc, n_steps, seed, step, chain_offset, uniforms,
            "imhk_fused", guard.row("imhk_fused"))
        count("imhk_fused", resident_chains=resident, wide=wide,
              runtime_window=runtime_window(ops.window))
        if own:
            guard.check("imhk_fused")
        return x, lw, acc


def imhk_trajectory(ops: KleinOperands, x, lw, acc, n_keep: int,
                    thin: int = 1, *, seed: int = 0, step: int = 0,
                    chain_offset: int = 0, uniforms=None,
                    coeffs: bool = False, guard=None):
    """B3: n_keep * thin fused IMHK steps in one launch (B2, state in
    place), writing the lw of every thin-th state to a ring tlw
    (n_keep, B) and, with `coeffs`, the state to tx (n_keep * n_pad, B).
    Returns (x, lw, acc, tx or None, tlw). `guard` as for `imhk_fused`.
    CPU operands run `imhk_trajectory_plain`."""
    if ops.device.type == "cpu":
        return imhk_trajectory_plain(ops, x, lw, acc, n_keep, thin,
                                     seed=seed, step=step,
                                     chain_offset=chain_offset,
                                     uniforms=uniforms, coeffs=coeffs)
    if n_keep < 1 or thin < 1:
        raise ValueError(f"n_keep {n_keep} and thin {thin} must be >= 1")
    own = guard is None
    if own:
        guard = ExactGuard(ops.device)
    tlw, tx = _trajectory_ring(x, n_keep, coeffs)
    resident, wide = _imhk_tc_launch(
        ops, x, lw, acc, n_keep * thin, seed, step, chain_offset, uniforms,
        "imhk_trajectory", guard.row("imhk_trajectory"), tlw=tlw, tx=tx,
        thin=thin)
    count("imhk_trajectory", resident_chains=resident, wide=wide,
          runtime_window=runtime_window(ops.window))
    if own:
        guard.check("imhk_trajectory")
    return x, lw, acc, tx, tlw


def imhk_centres_plain(ops: KleinOperands, x, lw, *, seed: int = 0,
                       step: int = 0, chain_offset: int = 0):
    """Plain version of `imhk_centres`: one IMHK step (B2's plain version,
    state in place) that also returns its proposal's conditional centres
    and the proposal, each (n_pad, B)."""
    centres, prop = torch.zeros_like(x), torch.zeros_like(x)
    imhk_fused_plain(ops, x, lw, torch.zeros_like(lw), 1, seed=seed,
                     step=step, chain_offset=chain_offset, centres=centres,
                     proposal=prop)
    return centres, prop


def imhk_centres(ops: KleinOperands, x, lw, *, seed: int = 0,
                 step: int = 0, chain_offset: int = 0):
    """B2's debug instantiation: one fused IMHK step (state x, lw in place)
    that also writes its proposal's conditional centres c_i, as the kernel
    forms them, and the proposal. Returns (centres, proposal), each
    (n_pad, B), recentred. For holding the kernel's own centres to float64;
    not a launch of the main path. CPU operands run
    `imhk_centres_plain`."""
    if ops.device.type == "cpu":
        return imhk_centres_plain(ops, x, lw, seed=seed, step=step,
                                  chain_offset=chain_offset)
    dbg = torch.empty(2 * ops.n_pad, x.shape[1], dtype=torch.float32,
                      device=ops.device)
    guard = ExactGuard(ops.device)
    _imhk_tc_launch(ops, x, lw, torch.zeros_like(lw), 1, seed, step,
                    chain_offset, None, "imhk_centres",
                    guard.row("imhk_fused"), dbg=dbg)
    guard.check("imhk_centres")
    return dbg[:ops.n_pad], dbg[ops.n_pad:]


def imhk_tc_resources(n_pad: int, window: int, wide: bool = False) -> dict:
    """B2/B3's kernel (its WIDE instantiation with `wide`) for `window` at
    n_pad on the current card: registers and local (spill) bytes a thread,
    dynamic shared memory and threads a block, blocks resident per SM and
    the chains they hold."""
    out = (ctypes.c_int * 5)()
    raise_on("imhk_tc", load("imhk_tc").imhk_tc_info(n_pad, window,
                                                      int(wide), out),
             "imhk_tc_info")
    res = dict(zip(("registers", "local_bytes", "shared_bytes",
                    "blocks_per_sm", "threads"), list(out)))
    res["resident_chains"] = res["blocks_per_sm"] * TC_CHAINS
    return res


# (device, n_pad, window, wide) -> chains of B2/B3 resident an SM
_RESIDENCY: dict = {}


def imhk_tc_residency(n_pad: int, window: int, wide: bool, device) -> int:
    """Chains an SM holds of B2/B3's kernel at n_pad and `window` (WIDE
    with `wide`), `imhk_tc_resources`' `resident_chains`, queried once per
    (device, n_pad, window, wide) so that no launch pays for the query.
    The query runs on `device`, not the current card."""
    key = (str(device), n_pad, window, bool(wide))
    chains = _RESIDENCY.get(key)
    if chains is None:
        with torch.cuda.device(device):
            chains = _RESIDENCY[key] = imhk_tc_resources(
                n_pad, window, wide)["resident_chains"]
    return chains
