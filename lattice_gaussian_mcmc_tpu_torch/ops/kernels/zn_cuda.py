"""I.i.d. draws of D_{Z, sigma, c} (B8) on Hopper: the wrapper of the CUDA
kernel in `csrc/zn.cu` and its plain PyTorch version.

Replaces the Pallas kernel `lattice_gaussian_mcmc_tpu/ops/kernels/zn_pallas.py`
`_kernel` (`sample_zn_pallas`), the direct Z^n sampler: one window CDF for a
scalar (sigma, centre), then one inverse-CDF lookup per draw. The output is
flat, (num,), in draw order; reshape it for Z^n vectors.

Randomness. Either the caller passes the uniforms, flat (num,) in draw order
(the Pallas wrapper's `unif.reshape(-1)` lines up with its
`out.reshape(-1)`), or the kernel draws Philox uniforms: draw 4j + w takes
output word w of counter (j low word, j high word, 0, TAG_ZN), one call for
four draws — `utils/prng.py` `draw_uniforms`.

Dispatch. A CPU device (or CPU uniforms) runs the plain version; a CUDA
device launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
    window_offsets,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    check_cuda,
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import count
from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    draw_uniforms,
    seed_key,
)

MAX_WINDOW = 1024


def _params(sigma, center):
    """(centre, 1 / sigma) as float32 numbers: the kernel's scalars."""
    return (float(np.float32(center)),
            float(np.float32(1.0) / np.float32(sigma)))


def zn_cdf(sigma, center, window: int, device):
    """(base, cdf (W,)) of the kernel's window with its float32
    arithmetic: z_k = (support_k - c) * isg, logit = (-0.5 z) z, max-shifted
    exps and a sequential prefix sum."""
    c, isg = _params(sigma, center)
    ct = torch.tensor(c, dtype=torch.float32, device=device)
    base = torch.round(ct)
    support = base + window_offsets(window, torch.float32, device)
    z = (support - ct) * torch.tensor(isg, dtype=torch.float32,
                                       device=device)
    logits = (-0.5 * z) * z
    w = torch.exp(logits - logits.max())
    cdf = torch.empty_like(w)
    run = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(window):
        run = run + w[k]
        cdf[k] = run
    return base, cdf


def sample_zn_draws_plain(num: int, sigma, center=0.0,
                          window: int = DEFAULT_WINDOW, *, seed: int = 0,
                          uniforms=None, device=None):
    """Plain version of B8: (num,) float32 draws on `device` (that of the
    uniforms when given)."""
    if uniforms is not None:
        device = uniforms.device
    device = resolve_device(device)
    base, cdf = zn_cdf(sigma, center, window, device)
    u = (uniforms.reshape(-1).to(torch.float32) if uniforms is not None
         else draw_uniforms(seed, num, device))
    idx = torch.searchsorted(cdf, u * cdf[-1], side="left")
    idx = idx.clamp_(max=window - 1)
    return base + (idx - window // 2).to(torch.float32)


def sample_zn_draws(num: int, sigma, center=0.0,
                    window: int = DEFAULT_WINDOW, *, seed: int = 0,
                    uniforms=None, device=None):
    """B8: num i.i.d. draws of D_{Z, sigma, center} in one launch, (num,)
    float32. A CPU device runs `sample_zn_draws_plain`."""
    if uniforms is not None:
        device = uniforms.device
    device = resolve_device(device)
    if device.type == "cpu":
        return sample_zn_draws_plain(num, sigma, center, window, seed=seed,
                                     uniforms=uniforms, device=device)
    if num < 1:
        raise ValueError(f"num {num} must be >= 1")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window {window} outside [1, {MAX_WINDOW}]")
    if uniforms is not None:
        check_cuda("uniforms", uniforms, (num,))
    c, isg = _params(sigma, center)
    lib = load("zn")
    out = torch.empty(num, dtype=torch.float32, device=device)
    k0, k1 = seed_key(seed)
    rc = lib.zn_draw_launch(
        c, isg, window, ptr(uniforms) if uniforms is not None else None,
        ptr(out), num, k0, k1,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    raise_on("zn", rc, "sample_zn_draws")
    count("sample_zn_draws")
    return out

