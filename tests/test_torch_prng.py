"""Philox4x32-10 of the port (`utils/prng.py`): known-answer vectors of the
Random123 reference, the counter layout, and batch independence."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    TAG_ROW,
    chain_ids,
    philox4x32,
    philox_uniform,
)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = philox4x32(*c, *key)
    assert tuple(int(w) for w in got) == want


def test_uniforms_independent_of_batch_size():
    rows = torch.arange(40)
    a = philox_uniform(7, chain_ids(128), 3, rows)
    b = philox_uniform(7, chain_ids(256), 3, rows)
    assert torch.equal(a, b[:, :128])
    # a chain offset addresses the same streams
    c = philox_uniform(7, chain_ids(128, chain_offset=128), 3, rows)
    assert torch.equal(c, b[:, 128:])


def test_streams_differ_by_step_tag_and_seed():
    rows, ch = torch.arange(16), chain_ids(64)
    base = philox_uniform(1, ch, 0, rows, TAG_ROW)
    for other in (philox_uniform(1, ch, 1, rows, TAG_ROW),
                  philox_uniform(1, ch, 0, rows, TAG_ACCEPT),
                  philox_uniform(2, ch, 0, rows, TAG_ROW),
                  philox_uniform(1 << 32, ch, 0, rows, TAG_ROW)):
        assert (other != base).float().mean() > 0.99


def test_uniform_range_and_moments():
    u = philox_uniform(11, chain_ids(4096), 0, torch.arange(64)).numpy()
    assert u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0
    # 23-bit mantissa grid: every value is a multiple of 2^-23
    assert np.all(np.mod(u * 2.0 ** 23, 1.0) == 0)
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / u.size)
    assert abs(u.var() - 1 / 12) < 1e-3
