"""Adaptive-precision Klein sampling (counterpart of the JAX package's
`samplers/adaptive.py`): path selection from a deterministic forward-error
bound.

The float32 draw computes the conditional means c_i = cs_i - sum_j U_ij x_j
in float32, whose rounding perturbs the per-coordinate law. The bound below
(the JAX package's arithmetic, on the host in float64) is compared against
the requested law tolerance:

  f32 error bound <= rtol  ->  kernel B1 on float32 operands on a card,
                               its plain version in float32 on the CPU
  otherwise                ->  the float64 per-row `klein_sample_batch`

Error model: with the exact coupling every product is float32-quality, so
|c_err| <= gamma eps32 max_i sum_j |U_ij| x_scale with gamma a small
constant, and the per-coordinate log-density distortion is
<= (|c_err| / sigma_i) window / 2 (Lipschitz bound on the windowed logits).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    KleinPrecomp,
    klein_precompute,
    klein_sample_batch,
)


def f32_law_distortion_bound(pre: KleinPrecomp) -> float:
    """Deterministic bound on the per-coordinate log-density distortion of
    the float32 sampling path on this precomputation.

    x_scale: the drawn coefficients (recentred) are bounded by the
    conditional spread ~6 max sigma_i plus the centre fraction; couplings
    sum |U_ij| over the row."""
    U = pre.U.detach().cpu().numpy().astype(np.float64)
    sig = pre.sigmas.detach().cpu().numpy().astype(np.float64)
    cs = pre.cs.detach().cpu().numpy().astype(np.float64)
    eps32 = float(np.finfo(np.float32).eps)
    x_scale = 6.0 * float(np.max(sig)) + 1.0
    row_l1 = np.abs(U - np.eye(U.shape[0])).sum(axis=1)
    # f32 sequential accumulation over the row: |c_err| <~ eps * sum|terms|
    c_err = 2.0 * eps32 * (row_l1 * x_scale + np.abs(cs))
    # the bf16-split coupling is exact only while the recentred draws stay
    # bf16-representable (|y| <= 256); beyond that each coefficient picks
    # up up to 2^-9 relative rounding, which the f32 model does not see.
    # The JAX package inflates its bound by that term, and so does this
    # copy, though B1 switches to its WIDE instantiation there (fault C11)
    if x_scale > 256.0:
        c_err = c_err + (2.0 ** -9) * x_scale * row_l1
    distortion = (c_err / np.maximum(sig, 1e-300)) * (pre.window / 2.0)
    return float(np.max(distortion))


def choose_precision(pre: KleinPrecomp, rtol: float = 1e-2) -> str:
    """'f32' when the bound is within rtol, else 'f64'."""
    return "f32" if f32_law_distortion_bound(pre) <= rtol else "f64"


def _float64_lattice(lattice: Lattice) -> Lattice:
    return dataclasses.replace(
        lattice, basis=lattice.basis.double(), Q=lattice.Q.double(),
        R=lattice.R.double(), gs_norms=lattice.gs_norms.double())


def adaptive_klein_sample(lattice: Lattice, sigma: float, num_samples: int,
                          rtol: float = 1e-2, center=None, seed: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Klein batch with automatic precision escalation, on the lattice's
    device. Returns (coeffs (B, n), log_ws (B,), info); info records the
    bound (`f32_distortion_bound`), `rtol` and the path that ran:
    "cuda_f32" (kernel B1), "plain_f32" (B1's plain version in float32 on
    the CPU) or "plain_f64" (the float64 per-row `klein_sample_batch`).

    PyTorch has float64 on every device, so the JAX package's
    "xla_f32_escalation_unavailable" branch (x64 disabled) has no
    counterpart: escalation always runs."""
    pre = klein_precompute(lattice, sigma, center=center)
    bound = f32_law_distortion_bound(pre)
    info = {"f32_distortion_bound": bound, "rtol": rtol}
    if bound <= rtol:
        ops = klein_cuda.kernel_operands(pre, dtype=torch.float32)
        info["path"] = ("cuda_f32" if ops.device.type == "cuda"
                        else "plain_f32")
        y, lw = klein_cuda.klein_draw(ops, num_samples, seed=seed)
        return klein_cuda.from_kernel_layout(ops, y), lw, info
    # escalate: the whole precomputation in float64 (the host GSO already is)
    info["path"] = "plain_f64"
    pre64 = klein_precompute(_float64_lattice(lattice), sigma, center=center,
                             window=pre.window)
    X, lw = klein_sample_batch(pre64, num_samples, seed=seed)
    return X, lw, info
