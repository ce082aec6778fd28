"""Counter-based random numbers: Philox4x32-10 in plain PyTorch.

Every uniform is a pure function of (seed, chain id, step, row, tag), so a
chain's draws do not depend on how many chains share a batch — the property
`fold_in(chain_id)` gives the JAX package's paths. The CUDA kernels in
`csrc/` compute the same function bit for bit; both use the
counter layout below and the same mantissa-trick uniform.

Counter layout: c0 = chain id, c1 = row, c2 = step, c3 = tag (TAG_ROW for
a coordinate draw, TAG_ACCEPT for a Metropolis accept uniform, TAG_NORMAL
for a pair of Box-Muller normals, TAG_GUMBEL for the Gumbel-max uniforms of
the plain Peikert draw, TAG_GIBBS for the Gibbs sweeps, TAG_HASH for the
signer's hash-to-point); key = (seed mod
2^32, seed >> 32 mod 2^32). Uniforms use output word 0; a Box-Muller pair
uses words 0 and 1. The Z^n draws (TAG_ZN) count groups of four draws, not
chains and rows: c0, c1 = the low and high words of the 64-bit group
index j, c2 = 0, and draw 4j + w takes output word w. The hash-to-point
(TAG_HASH, `ops/kernels/sign_cuda.py`) counts messages and groups of four
coefficients: coefficient j of message m is output word j mod 4 of counter
(m, j div 4, 0, TAG_HASH), reduced mod q. The signer's coordinate draws
take the midpoint uniform (`philox_midpoint`), (k + 1/2) 2^-23 in place of
k 2^-23, which excludes 0.

uint32 arithmetic is carried in int64 tensors: every product is split into
16-bit halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF

TAG_ROW = 0
TAG_ACCEPT = 1
TAG_NORMAL = 2
TAG_GUMBEL = 3
TAG_ZN = 4
TAG_GIBBS = 5
TAG_HASH = 6


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, x uint32 in int64."""
    p_lo = x * (m & 0xFFFF)          # < 2^48
    p_hi = x * (m >> 16)             # < 2^48
    t = p_hi + (p_lo >> 16)          # product = t * 2^16 + (p_lo & 0xFFFF)
    hi = t >> 16
    lo = ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on broadcastable int64 tensors holding uint32 values.
    Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def mantissa_uniform(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits under the exponent of 1.0 give a float in
    [1, 2); minus 1 gives a float32 uniform in [0, 1) (exact)."""
    fbits = ((bits & 0x7FFFFF) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def seed_key(seed: int):
    seed = int(seed)
    return seed & MASK32, (seed >> 32) & MASK32


def _step_word(step, device) -> torch.Tensor:
    """Counter word c2 as a (1, 1) int64 tensor on `device`: `step` is a
    Python int, or a one-element integer tensor on `device` (a chain's step
    counter), read on the device and never on the host, so a CUDA graph
    that captures the draw reads the counter's value at each replay. Both
    give the same word."""
    if isinstance(step, torch.Tensor):
        return (step.to(torch.int64) & MASK32).reshape(1, 1)
    return torch.full((1, 1), int(step) & MASK32, dtype=torch.int64,
                      device=device)


def philox_words(seed: int, chains: torch.Tensor, step,
                 rows: torch.Tensor, tag: int = TAG_ROW):
    """The four Philox output words of counter (chains[b], rows[r], step,
    tag) under `seed`, each of shape (len(rows), len(chains)). `step` is an
    int or a one-element int64 tensor on the chains' device
    (`_step_word`)."""
    k0, k1 = seed_key(seed)
    c0 = (chains.to(torch.int64) & MASK32)[None, :]
    c1 = (rows.to(torch.int64) & MASK32)[:, None]
    c2 = _step_word(step, chains.device)
    c3 = torch.full((1, 1), int(tag) & MASK32, dtype=torch.int64,
                    device=chains.device)
    return philox4x32(c0, c1, c2, c3, k0, k1)


def philox_uniform(seed: int, chains: torch.Tensor, step,
                   rows: torch.Tensor, tag: int = TAG_ROW) -> torch.Tensor:
    """float32 uniforms of shape (len(rows), len(chains)): entry (r, b) is
    the uniform of counter (chains[b], rows[r], step, tag) under `seed`;
    `step` as for `philox_words`."""
    return mantissa_uniform(philox_words(seed, chains, step, rows, tag)[0])


# half a step of the 23-bit uniform
MIDPOINT = 2.0 ** -24


def philox_midpoint(seed: int, chains: torch.Tensor, step,
                    rows: torch.Tensor, tag: int = TAG_ROW) -> torch.Tensor:
    """`philox_uniform` half a step up: (k + 1/2) 2^-23 for the 23-bit
    draw k, exact in float32, in (0, 1) and symmetric about 1/2. An inverse
    CDF never maps it to a point whose cumulative mass is 0, as it maps
    k = 0 (probability 2^-23) to the window's first point. The FALCON
    signer's draws (centred B1, `ops/kernels/sign_cuda.py`)."""
    return philox_uniform(seed, chains, step, rows, tag) + MIDPOINT


def chain_ids(num_chains: int, chain_offset: int = 0,
              device=None) -> torch.Tensor:
    """Global chain ids [offset, offset + num_chains) as int64."""
    return torch.arange(chain_offset, chain_offset + num_chains,
                        dtype=torch.int64, device=device)


def draw_uniforms(seed: int, num: int, device=None) -> torch.Tensor:
    """float32 uniforms of the Z^n draws 0 .. num-1 under `seed`: draw
    4j + w is output word w of counter (j low word, j high word, 0,
    TAG_ZN). Draw i does not depend on num."""
    j = torch.arange(-(-num // 4), dtype=torch.int64, device=device)
    k0, k1 = seed_key(seed)
    c2 = torch.zeros((1,), dtype=torch.int64, device=device)
    c3 = torch.full((1,), TAG_ZN, dtype=torch.int64, device=device)
    words = philox4x32(j & MASK32, j >> 32, c2, c3, k0, k1)
    return mantissa_uniform(torch.stack(words, dim=1).reshape(-1)[:num])
