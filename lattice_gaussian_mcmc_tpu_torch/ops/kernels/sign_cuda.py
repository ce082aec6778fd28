"""The FALCON signer's own kernels on Hopper, hash-to-point and the
uniforms of a redraw round: the wrappers of `csrc/sign.cu` and their plain
PyTorch versions.

The targets of M messages, c (M, n) int64 uniform on Z_q^n, come from the
port's Philox stream (`utils/prng.py`) in place of SHAKE-256: coefficient
j of message m is output word j mod 4 of counter (m, j div 4, 0, TAG_HASH)
under the call's seed, reduced mod q (the bias of 2^32 mod q kept). A
message's target does not depend on how many messages share the call.

Dispatch. Given a CUDA device the kernel runs; given the CPU its plain
version. It never falls back.

A redraw round (`redraw_uniforms`) draws the failing messages again on the
uniforms centred B1 would make in-kernel for their chain ids at the
round's Philox step: row i of message m is the midpoint uniform
(`utils/prng.py` `philox_midpoint`, (k + 1/2) 2^-23) of word 0 of counter
(m, i, step, TAG_ROW).
"""

from __future__ import annotations

import ctypes

import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import count
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_HASH,
    TAG_ROW,
    chain_ids,
    philox_midpoint,
    philox_words,
    seed_key,
)

HASH_GROUP = 4     # coefficients a Philox call (its four output words)


def hash_to_point_plain(seed: int, num_messages: int, n: int, q: int,
                        device=None) -> torch.Tensor:
    """Plain version of `hash_to_point`: (num_messages, n) int64."""
    groups = -(-n // HASH_GROUP)
    words = philox_words(seed, chain_ids(num_messages, 0, device), 0,
                         torch.arange(groups, device=device), TAG_HASH)
    c = torch.stack(words, dim=-1)                     # (groups, M, 4)
    return (c.permute(1, 0, 2).reshape(num_messages, -1)[:, :n]
            % int(q)).contiguous()


def hash_to_point(seed: int, num_messages: int, n: int, q: int,
                  device) -> torch.Tensor:
    """The targets c (num_messages, n) int64 in [0, q) of messages 0 ..
    num_messages - 1 under `seed`, on `device`: one launch of
    `csrc/sign.cu` on a card, the plain version on the CPU."""
    device = torch.device(device)
    if num_messages < 1 or n < 1 or not 2 <= q < 2 ** 32:
        raise ValueError(f"hash_to_point: {num_messages} messages, n {n}, "
                         f"q {q}")
    if device.type == "cpu":
        return hash_to_point_plain(seed, num_messages, n, q, device)
    c = torch.empty(num_messages, n, dtype=torch.int64, device=device)
    k0, k1 = seed_key(seed)
    rc = load("sign").hash_to_point_launch(
        ptr(c), num_messages, n, q, k0, k1,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    raise_on("sign", rc, "hash_to_point")
    count("hash_to_point")
    return c


def redraw_uniforms_plain(seed: int, ids: torch.Tensor, step: int,
                          n_rows: int) -> torch.Tensor:
    """Plain version of `redraw_uniforms`: (n_rows, len(ids)) float32."""
    return philox_midpoint(seed, ids, step,
                           torch.arange(n_rows, device=ids.device), TAG_ROW)


def redraw_uniforms(seed: int, ids: torch.Tensor, step: int,
                    n_rows: int) -> torch.Tensor:
    """The midpoint uniforms (n_rows, len(ids)) float32 of rows 0 ..
    n_rows - 1 of the chains `ids` (int64, on the device) at Philox step
    `step` under `seed`: one launch of `csrc/sign.cu` on a card, the plain
    version on the CPU."""
    if ids.device.type == "cpu":
        return redraw_uniforms_plain(seed, ids, step, n_rows)
    ids = ids.to(torch.int64).contiguous()
    u = torch.empty(n_rows, ids.numel(), dtype=torch.float32,
                    device=ids.device)
    k0, k1 = seed_key(seed)
    rc = load("sign").redraw_uniforms_launch(
        ptr(u), ptr(ids), ids.numel(), n_rows, step, k0, k1,
        ctypes.c_void_p(torch.cuda.current_stream(ids.device).cuda_stream))
    raise_on("sign", rc, "redraw_uniforms")
    count("redraw_uniforms")
    return u

