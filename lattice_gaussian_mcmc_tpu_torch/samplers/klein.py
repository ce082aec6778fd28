"""Klein's randomized-rounding sampler: precomputation, window policy,
log-weights, a plain per-row batched draw and `KleinSampler`, which draws
through kernel B1 (counterpart of the JAX package's `samplers/klein.py`).

Because sigma_i = sigma / R_ii cancels the quadratic terms, the IMHK
importance weight of a Klein draw is log w(x) = sum_i log Z_i, the sum of
the per-coordinate window normalizers; every draw returns it.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
    dgauss_logits,
    sample_dgauss_icdf_with_logz,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import points_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    ExactGuard,
)
from lattice_gaussian_mcmc_tpu_torch.utils.device import (
    check_backend,
    resolve_device,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import chain_ids, philox_uniform
from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

MAX_WINDOW = 1024


@dataclasses.dataclass
class KleinPrecomp:
    """Center-dependent precomputation for Klein sampling on one lattice.

    Fields:
      basis:   (n, n) basis (columns = basis vectors).
      U:       (n, n) unit-diagonal upper-triangular R / diag(R).
      cs:      (n,) scaled transformed center (Q^T c) / diag(R).
      sigmas:  (n,) conditional widths sigma / R_ii.
      sigma:   scalar target width (0-d tensor).
      window:  window size of the 1D draws.
      clamped: True when the requested window exceeded MAX_WINDOW and was
               truncated (the sampled law then has its tails cut).
    """

    basis: torch.Tensor
    U: torch.Tensor
    cs: torch.Tensor
    sigmas: torch.Tensor
    sigma: torch.Tensor
    window: int = DEFAULT_WINDOW
    clamped: bool = False

    @property
    def n(self) -> int:
        return self.basis.shape[0]

    @property
    def device(self) -> torch.device:
        return self.U.device

    def to(self, device) -> "KleinPrecomp":
        return dataclasses.replace(
            self, basis=self.basis.to(device), U=self.U.to(device),
            cs=self.cs.to(device), sigmas=self.sigmas.to(device),
            sigma=self.sigma.to(device))


def suggest_window(max_cond_sigma: float, tau: float = 6.0) -> int:
    """Smallest multiple-of-8 window covering +-tau conditional sigmas."""
    w = 2 * int(math.ceil(tau * max(1.0, float(max_cond_sigma)))) + 2
    return max(8, ((w + 7) // 8) * 8)


def suggest_window_budget(cond_sigmas, budget: float = 0.01,
                          max_window: int = 1024) -> int:
    """Smallest multiple-of-8 window whose total truncated tail mass over the
    whole conditional-sigma profile stays under `budget`. Per coordinate the
    nearest omitted support point sits at d0 = w/2 - 1/2 in the worst center
    offset, and the discrete one-sided tails are bounded by

        tail_i <= erfc(d0 / (sigma_i sqrt 2))
                  + 2 exp(-d0^2 / 2 sigma_i^2) / (sigma_i sqrt(2 pi)).

    On the NTRU-512 FALCON-sigma profile this gives window 16."""
    sig = np.abs(np.asarray(cond_sigmas, dtype=np.float64))
    sig = np.maximum(sig, 1e-30)
    for w in range(8, max_window + 1, 8):
        d0 = w / 2 - 0.5
        cont = np.array([math.erfc(x) for x in d0 / (sig * math.sqrt(2.0))])
        point = 2.0 * np.exp(-0.5 * (d0 / sig) ** 2) / (
            sig * math.sqrt(2.0 * math.pi))
        if float(np.sum(cont + point)) <= budget:
            return w
    return max_window


def klein_precompute(lattice: Lattice, sigma, center=None,
                     window: Optional[int] = None, tau: float = 6.0,
                     tail_budget: Optional[float] = None) -> KleinPrecomp:
    """Klein precomputation on the lattice's device and dtype. Without a
    `window`, `tail_budget` (when set) picks it by `suggest_window_budget`,
    otherwise `tau` by `suggest_window`."""
    with span("lgm.setup.precompute"):
        R = lattice.R
        r_diag = torch.diagonal(R)
        sigma_t = torch.as_tensor(float(sigma), dtype=R.dtype,
                                  device=R.device)
        sigmas = sigma_t / r_diag
        if center is None:
            cs = torch.zeros(lattice.n, dtype=R.dtype, device=R.device)
        else:
            c = torch.as_tensor(np.asarray(center),
                                dtype=R.dtype).to(R.device)
            cs = (lattice.Q.T @ c) / r_diag
        clamped = False
        if window is None:
            sig_np = sigmas.cpu().numpy().astype(np.float64)
            max_cond = float(sig_np.max())
            if not math.isfinite(max_cond):
                raise ValueError(
                    "singular basis: a Gram-Schmidt norm is zero, so a "
                    "conditional sigma is infinite")
            if tail_budget is not None:
                window = suggest_window_budget(sig_np, tail_budget)
            else:
                window = suggest_window(max_cond, tau=tau)
            if window > MAX_WINDOW:
                warnings.warn(
                    f"conditional sigma {max_cond:.3g} needs window "
                    f"{window} > {MAX_WINDOW}; clamping — tails beyond the "
                    "window are truncated", stacklevel=2)
                window = MAX_WINDOW
                clamped = True
        U = R / r_diag[:, None]
        return KleinPrecomp(basis=lattice.basis, U=U, cs=cs, sigmas=sigmas,
                            sigma=sigma_t, window=int(window), clamped=clamped)


def klein_precomp_from_numpy(d: Dict[str, np.ndarray], dtype=torch.float64,
                             device=None) -> KleinPrecomp:
    """A `KleinPrecomp` from the JAX object's fields as numpy arrays
    (`basis, U, cs, sigmas, sigma, window, clamped`), so both packages
    sample from the same precomputation."""
    device = resolve_device(device)

    def t(k):
        return torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)

    return KleinPrecomp(basis=t("basis"), U=t("U"), cs=t("cs"),
                        sigmas=t("sigmas"), sigma=t("sigma"),
                        window=int(d["window"]), clamped=bool(d["clamped"]))


def klein_sample_batch(pre: KleinPrecomp, num_samples: int, seed: int = 0,
                       step: int = 0, chain_offset: int = 0, centers=None):
    """Plain per-row batched Klein draw: backward substitution over rows
    i = n-1..0, one inverse-CDF draw per row from the uniform of counter
    (chain, row i, step). `centers` (B, n), when given, replaces the scaled
    centre pre.cs chain by chain. `step` is an int or a one-element int64
    tensor on the device (a captured chain's step counter,
    `utils/graphs.py`). Returns (coeffs (B, n), log_w (B,)) in the
    precomputation's dtype."""
    n, dev = pre.n, pre.device
    u = philox_uniform(seed, chain_ids(num_samples, chain_offset, dev), step,
                       torch.arange(n, device=dev)).to(pre.U.dtype)
    cs = pre.cs if centers is None else centers.to(pre.U.dtype).T
    X = torch.zeros(num_samples, n, dtype=pre.U.dtype, device=dev)
    lw = torch.zeros(num_samples, dtype=pre.U.dtype, device=dev)
    for i in range(n - 1, -1, -1):
        # columns j <= i of X are still 0, so the full row is the j > i sum
        c = cs[i] - X @ pre.U[i]
        z, logz = sample_dgauss_icdf_with_logz(u[i], c, pre.sigmas[i],
                                               pre.window)
        X[:, i] = z
        lw = lw + logz
    return X, lw


def klein_sample(pre: KleinPrecomp, seed: int = 0, step: int = 0,
                 chain: int = 0):
    """One Klein draw: chain `chain` of `klein_sample_batch` at the same
    seed and step (row c of a batch drawn from chain 0 is
    `klein_sample(pre, seed, step, chain=c)`). Returns (coeffs (n,),
    log_w scalar), log_w = sum_i log Z_i the IMHK log importance
    weight."""
    X, lw = klein_sample_batch(pre, 1, seed=seed, step=step,
                               chain_offset=chain)
    return X[0], lw[0]


def klein_points(basis, coeffs, limbs=None):
    """Map integer coefficients to lattice points: basis @ x (batched).
    With the basis's int8 limbs (`points_cuda.points_operands`, None for a
    basis that has none) and coefficients on a card, the exact int8 kernel
    (`csrc/points.cu`) computes them; otherwise the float64 product."""
    with span("lgm.layout.points"):
        if limbs is not None and coeffs.device.type == "cuda":
            return points_cuda.points(limbs, coeffs)
        return coeffs.to(basis.dtype) @ basis.T


def klein_log_density(coeffs, pre: KleinPrecomp):
    """Exact log q(x) of Klein's windowed law at integer coefficients x
    (B, n) or (n,): sum_i [-(x_i - c_i)^2 / (2 sigma_i^2) - log Z_i], every
    conditional mean c_i a row of one triangular product."""
    x = torch.as_tensor(coeffs).to(pre.U.dtype)
    c = pre.cs - x @ pre.U.T + x      # c_i = cs_i - sum_{j>i} U_ij x_j
    _, logits = dgauss_logits(c, pre.sigmas.expand_as(c), pre.window)
    quad = -0.5 * ((x - c) / pre.sigmas) ** 2
    return (quad - torch.logsumexp(logits, dim=-1)).sum(dim=-1)


def klein_log_weight(coeffs, pre: KleinPrecomp):
    """log w(x) = sum_i log Z_i(c_i, sigma_i) at arbitrary x (B, n) or (n,):
    every conditional mean is a row of one triangular product."""
    x = torch.as_tensor(coeffs).to(pre.U.dtype)
    c = pre.cs - x @ pre.U.T + x      # c_i = cs_i - sum_{j>i} U_ij x_j
    _, logits = dgauss_logits(c, pre.sigmas.expand_as(c), pre.window)
    return torch.logsumexp(logits, dim=-1).sum(dim=-1)


class KleinSampler:
    """Klein's sampler on one lattice. `sample` draws through kernel B1 on
    a card and its plain version on the CPU (there is no silent fallback:
    with no card and no `device="cpu"`, construction raises)."""

    def __init__(self, lattice: Lattice, sigma: float, center=None,
                 window: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.lattice = lattice
        self.sigma = float(sigma)
        self.pre = klein_precompute(lattice, sigma, center,
                                    window).to(self.device)
        self.limbs = points_cuda.points_operands(self.pre.basis)
        self._ops = None
        self._validate()

    def _validate(self):
        n = self.lattice.n
        max_gs = float(torch.max(torch.abs(torch.diagonal(self.lattice.R))))
        klein_lower = max_gs / math.sqrt(2 * math.log(n + 1))
        if self.sigma < 0.9 * klein_lower:
            warnings.warn(
                f"sigma={self.sigma:.4g} below Klein requirement "
                f"(~{klein_lower:.4g}); samples may deviate from "
                f"D_(Lambda,sigma)", stacklevel=2)
        max_cond = float(torch.max(self.pre.sigmas))
        if 6.0 * max_cond > self.pre.window / 2:
            warnings.warn(
                f"window {self.pre.window} covers only "
                f"{self.pre.window / 2 / max_cond:.1f} conditional sigmas; "
                "increase `window`", stacklevel=2)

    @property
    def operands(self):
        """Kernel B1's operands (float32)."""
        if self._ops is None:
            # imported here: klein_cuda imports this module
            from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
                klein_cuda,
            )
            self._ops = klein_cuda.kernel_operands(self.pre)
        return self._ops

    def sample_with_weights(self, seed: int, num_samples: int,
                            backend: str = "auto"):
        """num_samples independent draws (one B1 launch): (coeffs (B, n),
        log_w (B,)). backend "cuda" raises unless the sampler is on a
        card."""
        from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
        check_backend(backend, self.device)
        ops = self.operands
        guard = ExactGuard(self.device)
        y, lw = klein_cuda.klein_draw(ops, num_samples, seed=seed, step=0,
                                      guard=guard)
        guard.check("KleinSampler.sample")
        return klein_cuda.from_kernel_layout(ops, y), lw

    def sample(self, seed: int, num_samples: int = 1,
               return_coeffs: bool = False, backend: str = "auto"):
        """num_samples independent draws as lattice points (B, n), or
        coefficients."""
        coeffs, _ = self.sample_with_weights(seed, num_samples, backend)
        if return_coeffs:
            return coeffs
        return klein_points(self.pre.basis, coeffs, self.limbs)

    def log_density(self, coeffs):
        return klein_log_density(coeffs, self.pre)

    def diagnostic_info(self):
        r = torch.abs(torch.diagonal(self.lattice.R))
        return {
            "algorithm": ("Klein, kernel B1" if self.device.type == "cuda"
                          else "Klein, kernel B1's plain version"),
            "sigma": self.sigma,
            "window": self.pre.window,
            "min_R_diag": float(torch.min(r)),
            "max_R_diag": float(torch.max(r)),
            "min_conditional_sigma": float(torch.min(self.pre.sigmas)),
            "max_conditional_sigma": float(torch.max(self.pre.sigmas)),
        }
