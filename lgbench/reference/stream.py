"""The random stream the port documents for its samplers, written out
plainly: Philox4x32-10 keyed by the call's seed, counter (chain id, row,
step, tag), and the uniforms and Box-Muller normals made from its words.

The layout is the port's published contract (its `utils/prng.py` and
`ops/kernels/peikert_cuda.py` docstrings): key = (seed mod 2^32,
seed >> 32 mod 2^32); a coordinate's uniform is output word 0 of counter
(chain, row i, step, TAG_ROW); an IMHK accept uniform word 0 of (chain, 0,
step, TAG_ACCEPT); the Peikert normals of rows 2p and 2p + 1 are the
Box-Muller pair of words 0 and 1 of (chain, p, round, TAG_NORMAL). A
uniform is 23 mantissa bits, k / 2^23. Nothing here imports the port.

uint32 arithmetic runs in int64 tensors; every product is split into 16-bit
halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
TAG_ROW, TAG_ACCEPT, TAG_NORMAL = 0, 1, 2
# the Box-Muller angle's constant as the stream defines it: 2 pi in float32
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32-bit words of m * x for x in [0, 2^32)."""
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    t = p1 + (p0 >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on broadcastable int64 tensors of uint32 values; the
    key words may be tensors too (one key per draw). Returns four words."""
    c0, c1, c2, c3, k0, k1 = torch.broadcast_tensors(c0, c1, c2, c3, k0, k1)
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & MASK
            k1 = (k1 + 0xBB67AE85) & MASK
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keys(seeds: torch.Tensor):
    """The key words of int64 seeds."""
    return seeds & MASK, (seeds >> 32) & MASK


def unit(word: torch.Tensor) -> torch.Tensor:
    """The uniform of a word: its low 23 bits over 2^23, in float64."""
    return (word & 0x7FFFFF).to(torch.float64) * 2.0 ** -23


def words(seeds, chains, rows, steps, tag: int):
    """Philox words of counter (chains, rows, steps, tag) under seeds; all
    int64 tensors broadcast together."""
    k0, k1 = keys(seeds)
    tag_t = torch.full((), tag, dtype=torch.int64, device=seeds.device)
    return philox(chains & MASK, rows & MASK, steps & MASK, tag_t, k0, k1)


def uniforms(seeds, chains, rows, steps, tag: int = TAG_ROW):
    """float64 uniforms (exact float32 values) of word 0."""
    return unit(words(seeds, chains, rows, steps, tag)[0])


def normals(seeds, chains, pairs, rnd: int):
    """The two Box-Muller normals of pair rows `pairs`: (z[2p], z[2p+1]),
    each broadcast over (seeds, chains, pairs), float64."""
    w = words(seeds, chains, pairs, torch.full((), rnd, dtype=torch.int64,
                                               device=seeds.device),
              TAG_NORMAL)
    u1 = 1.0 - unit(w[0])
    u2 = unit(w[1])
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = u2 * TWO_PI_F32
    return rad * torch.cos(ang), rad * torch.sin(ang)
