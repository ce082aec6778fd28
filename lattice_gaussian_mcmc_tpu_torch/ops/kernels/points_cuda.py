"""Lattice points P = x B^T from integer coefficients, exactly, on Hopper's
int8 tensor cores: the wrapper of `csrc/points.cu`, the basis's limbs made
once at set-up, the plain PyTorch version of the kernel's limb arithmetic
and its limb counts.

Every sampler of the port ends with integer coefficients x (rows, n) and an
integer basis B; their points are x B^T. The float64 product computes them
exactly while every partial sum stays below 2^53, at the card's FP64 rate.
Here both operands are split into 8-bit limbs whose products sum exactly in
int32 (`csrc/points.cu`).

Route. `points_operands(basis)` checks the basis once, at construction of
the sampler or signer that holds it: float64, square, integer-valued,
|B| < 2^15 and n <= MAX_DIM. Such a basis is split into its int8 limbs,
one where every entry lies in -128 .. 127 (the FALCON keys), else two; any
other basis gets None, and its points keep the float64 product. The
limb split is the basis's only host read. `klein_points` takes the kernel
for CUDA coefficients given operands, the float64 product otherwise (the
CPU included).

Coefficients. The kernel reads x where it lies, float32 or float64, with
rows or columns contiguous (Peikert's chain-minor ring view, the signer's
x.T, IMHK's row-major coefficients); another layout is copied first. Each
tile of x (TILE_ROWS x TILE_COLS) takes the fewest two's-complement bytes
that hold its values, decided on the device; `limb_stats` reads the
counts. A tile holding a value that is not an integer, not finite or
outside int32 is out of reach: the kernel writes NaN over its rows of P.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    count,
    device_counters,
    read_device_counters,
)
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

TILE_ROWS = 64     # rows of x a block, and of a tile's limb decision
TILE_COLS = 32     # columns of x a tile: one mma k-step
COL_GROUP = 256    # columns of P a block's warps take at once (B's padding)
MAX_BASIS = 2 ** 15
# keeps every int32 sum of the kernel below 2^31 (two limb pairs a shift,
# 255 * 255 a product)
MAX_DIM = 16384
MAX_LIMBS = 4      # bytes of an int32 coefficient
# k limbs (two's-complement bytes) hold -LIMB_REACH[k-1] .. LIMB_REACH[k-1]-1
LIMB_REACH = tuple(2 ** (8 * k - 1) for k in range(1, MAX_LIMBS + 1))


@dataclasses.dataclass
class PointsOperands:
    """The int8 limbs of an integer basis B (n, n), made once
    (`points_operands`).

      words:   (n_pad / 16, k_pad / TILE_COLS, n_limbs, 32, 4) int32, in
               mma.sync m16n8k32's B-fragment order: entry [i // 16, k // 32,
               b, lane, 2 nt + h] holds byte b of B[i, k' .. k' + 3]
               (little-endian) for column i = 16 (i // 16) + 8 nt + lane / 4
               and k' = 32 (k // 32) + 4 (lane % 4) + 16 h, zero padded (n_pad
               a multiple of COL_GROUP); byte b enters the products unsigned
               below the top limb, signed as the top one.
      n_limbs: 1 (every |B| entry in -128 .. 127) or 2.
      n:       the dimension.
    """

    words: torch.Tensor
    n_limbs: int
    n: int

    @property
    def device(self) -> torch.device:
        return self.words.device


def _bytes_of(v: torch.Tensor, b: int, signed: bool) -> torch.Tensor:
    """Byte b of the int64 tensor v (two's complement), as int64: unsigned,
    or sign-extended (the top limb)."""
    byte = (v >> (8 * b)) & 255
    return byte - ((byte & 128) << 1) if signed else byte


def points_operands(basis: torch.Tensor) -> Optional[PointsOperands]:
    """The limbs of `basis` (module docstring), or None where its points
    keep the float64 product: not float64, not square, not integer-valued,
    an entry with |B| >= 2^15, or n above MAX_DIM. One host read."""
    with span("lgm.setup.operands"):
        if (basis.dtype != torch.float64 or basis.ndim != 2
                or basis.shape[0] != basis.shape[1]
                or not 1 <= basis.shape[0] <= MAX_DIM):
            return None
        n = basis.shape[0]
        integral, top, narrow = torch.stack([
            (basis == torch.round(basis)).all().to(torch.float64),
            basis.abs().max(),
            ((basis >= -128) & (basis <= 127)).all().to(torch.float64),
        ]).tolist()
        if not integral or not top < MAX_BASIS:
            return None
        n_limbs = 1 if narrow else 2
        n_pad = -(-n // COL_GROUP) * COL_GROUP
        kc = -(-n // TILE_COLS)
        b = torch.zeros(n_pad, kc * TILE_COLS, dtype=torch.int64,
                        device=basis.device)
        b[:n, :n] = basis.to(torch.int64)
        # word [i, w] holds bytes k = 4w .. 4w + 3 of row i; i = 16 c + 8 nt
        # + g, w = 8 kt + 4 h + t, lane = 4 g + t
        planes = [((b >> (8 * i)) & 255).to(torch.uint8).view(torch.int32)
                  .reshape(n_pad // 16, 2, 8, kc, 2, 4)
                  .permute(0, 3, 2, 5, 1, 4).reshape(n_pad // 16, kc, 32, 4)
                  for i in range(n_limbs)]
        return PointsOperands(words=torch.stack(planes, dim=2).contiguous(),
                              n_limbs=n_limbs, n=n)


def basis_limbs(ops: PointsOperands) -> torch.Tensor:
    """The limbs (n_limbs, n, n) int64 of the basis that `ops` holds: bytes
    0 .. n_limbs - 2 unsigned, the top one signed."""
    n16, kc = ops.words.shape[:2]
    planes = ops.words.reshape(n16, kc, ops.n_limbs, 8, 4, 2, 2) \
        .permute(2, 0, 5, 3, 1, 6, 4).reshape(ops.n_limbs, n16 * 16, kc * 8)
    v = planes.contiguous().view(torch.uint8)[:, :ops.n, :ops.n] \
        .to(torch.int64)
    top = ops.n_limbs - 1
    return torch.stack([_bytes_of(v[b], 0, b == top)
                        for b in range(ops.n_limbs)])


def tile_limbs(coeffs: torch.Tensor) -> torch.Tensor:
    """Per tile of x (TILE_ROWS x TILE_COLS, the last ones ragged), the
    fewest two's-complement bytes that hold its values, (row tiles, column
    tiles) int64; 0 for a tile out of reach (a value not an integer, not
    finite or outside int32)."""
    x = coeffs.to(torch.float64)
    rows, n = x.shape
    rt, ct = -(-rows // TILE_ROWS), -(-n // TILE_COLS)
    pad = torch.zeros(rt * TILE_ROWS, ct * TILE_COLS, dtype=torch.float64,
                      device=x.device)
    pad[:rows, :n] = x
    ok = (pad == torch.round(pad)) & (pad >= -2.0 ** 31) & (pad < 2.0 ** 31)
    v = torch.where(ok, pad, torch.zeros_like(pad)).to(torch.int64)
    need = torch.ones_like(v)
    for k, reach in enumerate(LIMB_REACH[:-1], start=2):
        need = torch.where((v < -reach) | (v >= reach), k, need)
    need = torch.where(ok, need, torch.zeros_like(need))
    tiles = need.reshape(rt, TILE_ROWS, ct, TILE_COLS)
    limbs = tiles.amax(dim=(1, 3))
    out_of_reach = (tiles == 0).any(dim=3).any(dim=1)
    return torch.where(out_of_reach, torch.zeros_like(limbs), limbs)


def limb_counts(coeffs: torch.Tensor) -> dict:
    """The counts `limb_stats` reads after one launch on `coeffs`: tiles
    of x by limb count, and tiles out of reach."""
    la = tile_limbs(coeffs).flatten()
    out = {f"limbs_{k}": int((la == k).sum())
           for k in range(1, MAX_LIMBS + 1)}
    out["beyond"] = int((la == 0).sum())
    return out


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) @ b (N, K)^T in int64 on any device, a few rows at a
    time."""
    R, K = a.shape
    out = torch.empty(R, b.shape[0], dtype=torch.int64, device=a.device)
    step = max(1, (1 << 22) // max(1, b.shape[0] * K))
    for i in range(0, R, step):
        out[i:i + step] = (a[i:i + step, None, :] * b[None]).sum(dim=-1)
    return out


def points_plain(ops: PointsOperands, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain version of `points`, the kernel's arithmetic in int64: each
    tile of x split into its `tile_limbs` bytes (the top one signed), every
    limb pair's products summed per shift s = a + b, the shifts combined as
    sum_s acc_s 256^s and converted to float64 once; NaN over the row
    tiles that hold a tile out of reach. Returns (rows, n) float64."""
    rows, n = coeffs.shape
    if n != ops.n:
        raise ValueError(f"coefficients of dimension {n}, basis {ops.n}")
    la = tile_limbs(coeffs)
    per_value = la.repeat_interleave(TILE_ROWS, dim=0)[:rows] \
        .repeat_interleave(TILE_COLS, dim=1)[:, :n]
    x = coeffs.to(torch.float64)
    x = torch.where(per_value > 0, x, torch.zeros_like(x)).to(torch.int64)
    bl = basis_limbs(ops)
    acc = [torch.zeros(rows, n, dtype=torch.int64, device=coeffs.device)
           for _ in range(MAX_LIMBS + ops.n_limbs - 1)]
    for k in range(1, MAX_LIMBS + 1):
        xk = torch.where(per_value == k, x, torch.zeros_like(x))
        for a in range(k):
            xa = _bytes_of(xk, a, a == k - 1)
            for b in range(ops.n_limbs):
                acc[a + b] += _int_matmul(xa, bl[b])
    total = sum(s * 256 ** i for i, s in enumerate(acc))
    out = total.to(torch.float64)
    bad_rows = (la == 0).any(dim=1).repeat_interleave(TILE_ROWS)[:rows]
    out[bad_rows] = float("nan")
    return out


def limb_stats() -> dict:
    """The kernel's tiles of x since the last `launch_record.reset`, by
    the limb count each took (`limbs_1` .. `limbs_4`), and those out of
    reach (`beyond`); each tile counted once a launch. One
    synchronisation."""
    rows = read_device_counters("points")
    tot = [sum(r[i] for r in rows) for i in range(5)]
    out = {f"limbs_{k}": tot[k - 1] for k in range(1, MAX_LIMBS + 1)}
    out["beyond"] = tot[4]
    return out


def read_layout(coeffs: torch.Tensor):
    """How the kernel reads coeffs (rows, n): (coeffs, sr, sk, col, vec).
    Strides sr, sk in elements; col = 0 with columns contiguous (sk = 1),
    1 with rows contiguous (sr = 1), any other layout copied row-major
    first; vec = 1 where the runs along the unit stride split into whole,
    aligned 16-byte loads, 0 where the kernel loads element by element."""
    rows, n = coeffs.shape
    sr, sk = coeffs.stride()
    if n == 1:
        sk = 1
    elif rows == 1:
        sr = 1
    if sk != 1 and sr != 1:
        coeffs = coeffs.contiguous()
        sr, sk = coeffs.stride()
    col = int(sk != 1)
    per = 16 // coeffs.element_size()   # values a 16-byte load
    if col:      # loads along the rows, per rows at a time
        whole = rows % per == 0 and sk % per == 0
    else:        # along a row, four values at a time
        whole = n % 4 == 0 and (sr % per == 0 or rows == 1)
    vec = int(whole and coeffs.data_ptr() % 16 == 0)
    return coeffs, sr, sk, col, vec


def points(ops: PointsOperands, coeffs: torch.Tensor) -> torch.Tensor:
    """P = coeffs B^T (rows, n) float64, row-major, in one launch of
    `csrc/points.cu`: coeffs (rows, n) float32 or float64 on the card,
    integer-valued, read in place when rows or columns are contiguous.
    Does not wait; makes no host read. CPU coefficients run
    `points_plain`."""
    with span("lgm.kernel.points"):
        if coeffs.ndim != 2 or coeffs.shape[1] != ops.n:
            raise ValueError(f"coefficients must be (rows, {ops.n}), got "
                             f"{tuple(coeffs.shape)}")
        if coeffs.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"coefficients must be float32 or float64, got "
                             f"{coeffs.dtype}")
        if coeffs.device != ops.device:
            raise ValueError(f"coefficients on {coeffs.device}, limbs on "
                             f"{ops.device}")
        if coeffs.device.type == "cpu":
            return points_plain(ops, coeffs)
        rows, n = coeffs.shape
        out = torch.empty(rows, n, dtype=torch.float64, device=coeffs.device)
        if rows == 0:
            return out
        coeffs, sr, sk, col, vec = read_layout(coeffs)
        rc = load("points").points_launch(
            ptr(coeffs), coeffs.element_size(), col, sr, sk, rows, n, vec,
            ptr(ops.words), ops.n_limbs, ptr(out),
            ptr(device_counters("points", coeffs.device, 5, torch.int64)),
            ctypes.c_void_p(
                torch.cuda.current_stream(coeffs.device).cuda_stream))
        raise_on("points", rc, "points")
        count("points")
        return out

