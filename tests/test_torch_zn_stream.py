"""The Z^n draws' Philox stream (B8, `csrc/zn.cu`) on the CPU: draws
4j .. 4j + 3 are the four output words of counter (j, 0, 0, TAG_ZN), a
prefix of a longer run is the same draws, the plain version's law on that
stream, and the SASS count behind B8's bound. The kernel runs only on a
card (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import exact_pmf
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import zn_cuda
from lattice_gaussian_mcmc_tpu_torch.tools import sass
from lattice_gaussian_mcmc_tpu_torch.utils import prng


def _tvd(z, sigma, center=0.0):
    support, p = exact_pmf(sigma, center)
    emp = np.array([(z == k).mean() for k in support])
    return 0.5 * (np.abs(emp - p).sum() + (1.0 - emp.sum()))


@pytest.mark.parametrize("seed", [0, 3, (7 << 32) | 5])
def test_draws_4j_to_4j3_are_the_words_of_counter_j(seed):
    j = torch.arange(64, dtype=torch.int64)
    words = prng.philox4x32(j, j * 0, j * 0, j * 0 + prng.TAG_ZN,
                            *prng.seed_key(seed))
    u = prng.draw_uniforms(seed, 256)
    for w in range(4):
        assert torch.equal(u[w::4], prng.mantissa_uniform(words[w]))
    # no word is read twice within a group: four distinct uniforms
    assert all(len(set(g)) == 4 for g in u.reshape(64, 4).tolist())


def test_prefix_of_a_longer_run_is_the_same_draws():
    u = prng.draw_uniforms(11, 4099)
    for num in (1, 2, 3, 4, 5, 1001, 4096):
        assert torch.equal(prng.draw_uniforms(11, num), u[:num])
    z = zn_cuda.sample_zn_draws(4099, 5.0, 0.3, 48, seed=11, device="cpu")
    for num in (3, 1001):
        zp = zn_cuda.sample_zn_draws(num, 5.0, 0.3, 48, seed=11,
                                     device="cpu")
        assert torch.equal(zp, z[:num])


@pytest.mark.parametrize("sigma,center,window", [(5.0, 0.0, 48),
                                                 (1.5, 0.5, 32)])
def test_law_on_the_four_word_stream(sigma, center, window):
    """TVD to the exact pmf below 0.02 (the smoke's gate), 200,003 draws
    (not a multiple of four)."""
    z = zn_cuda.sample_zn_draws(200_003, sigma, center, window, seed=9,
                                device="cpu").numpy()
    assert _tvd(z, sigma, center) < 0.02


SASS = """
        code for sm_90a
                Function : zn_store_probe
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x0000 */
        /*0010*/                   S2R R0, SR_TID.X ;          /* 0x0000 */
        /*0020*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0030*/                   EXIT ;                      /* 0x0000 */
        /*0040*/                   BRA 0x40;                   /* 0x0000 */
        /*0050*/                   NOP;                        /* 0x0000 */
                ..........

                Function : zn_philox_probe
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x0000 */
        /*0010*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
        /*0020*/                   LOP3.LUT R5, R3, UR6, R4, 0x96, !PT ;
        /*0030*/               @P0 IADD3 R4, R4, 0x1, RZ ;
        /*0040*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0050*/                   EXIT ;                      /* 0x0000 */
        /*0060*/                   BRA 0x60;                   /* 0x0000 */
"""


def test_sass_instruction_count():
    """Instructions up to the first EXIT, NOPs and the trailing branch left
    out; the Philox count is the probe's less the store probe's."""
    assert sass.instructions(SASS, "zn_store_probe") == 4
    assert sass.instructions(SASS, "zn_philox_probe") == 6
