"""Fused symmetric Metropolis-Klein steps (B4) on Hopper: the wrapper of
the CUDA kernel in `csrc/smk_tc.cu`, its plain PyTorch version and the
operand preparation.

Replaces the Pallas kernel
`lattice_gaussian_mcmc_tpu/ops/kernels/smk_pallas.py` `_smk_kernel`
(`_smk_steps_jit`, `smk_steps_batch_pallas`).

Layout and randomness are B2's (`klein_cuda.py`): the state is the
chain-minor recentered integer vector y = x - k (n_pad, B) of the target
precomputation; host uniforms have n_pad + 8 rows per step with the accept
uniform in row n_pad, or the kernel draws Philox uniforms keyed by (seed,
chain id, step, row).

Operands follow `_smk_steps_jit`: the proposal widths are the target's
conditional widths times sigma_prop / sigma (padded rows 1e-6), the window
is `suggest_window_budget` on that proposal profile (budget 0.01, at most
1024), and the target enters as its recentered centre cse and
wqt_i = R_ii / (sqrt(2) sigma) (0 on padded rows, which then add nothing
to the target quadratics whatever they draw).

The kernel is B2's tensor-core sweep (`klein_cuda.py`): its coupling runs
over the exact bf16 split of U (`klein_cuda.tc_fragments`, built on the
first launch of an operand set and kept on it), so its products are exact
only while the state and the proposal's recentred coefficients are:
|y| <= 256 (hazard C8). The kernel counts coefficients beyond that into its
row of an `ExactGuard` (`launch_record.py`); the wrapper, or the entry
point that passed it one, raises before it returns. It keeps the proposal
in shared memory, which bounds n_pad by `SMK_TC_MAX_N_PAD`.

Dispatch. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import klein_cuda
from lattice_gaussian_mcmc_tpu_torch.ops.kernels._build import (
    check_cuda,
    load,
    ptr,
    raise_on,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.klein_cuda import (
    ACCEPT_ROWS,
    ROW_BLOCK,
    _draw_row_plain,
    _uniform_rows,
    _window_weights_plain,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels.launch_record import (
    ExactGuard,
    count,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (
    MAX_WINDOW,
    KleinPrecomp,
    suggest_window_budget,
)
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_ACCEPT,
    chain_ids,
    philox_uniform,
    seed_key,
)


@dataclasses.dataclass
class SMKOperands:
    """Kernel operands of one SMK configuration, in the working dtype.

      U, UT: the target's (n_pad, n_pad) unit upper-triangular factor and
             its transpose.
      cse:   (n_pad,) recentered target centre cs - U k.
      isgp:  (n_pad,) inverse proposal widths.
      wqt:   (n_pad,) R_ii / (sqrt(2) sigma), 0 on padded rows.
      shift: (n_pad,) the integer recentering k = round(cs).
      n:     the lattice dimension before padding.
      window: the proposal's window.
    """

    U: torch.Tensor
    UT: torch.Tensor
    cse: torch.Tensor
    isgp: torch.Tensor
    wqt: torch.Tensor
    shift: torch.Tensor
    n: int
    window: int

    @property
    def n_pad(self) -> int:
        return self.U.shape[0]

    @property
    def device(self) -> torch.device:
        return self.U.device


def smk_operands(pre: KleinPrecomp, sigma_prop: float, dtype=torch.float32,
                 klein_ops: Optional[klein_cuda.KleinOperands] = None
                 ) -> SMKOperands:
    """Operands of `pre` (the TARGET precomputation) with the proposal
    width `sigma_prop`. `klein_ops`, B1's operands of the same `pre`, are
    reused when given; on a card the result shares their U fragments
    (`klein_cuda.tc_fragments`), so operands made again for another
    sigma_prop do not pack U again."""
    n = pre.n
    sigma = float(pre.sigma)
    sigmas_prop = pre.sigmas.to(torch.float64) * (float(sigma_prop) / sigma)
    prof = np.abs(sigmas_prop.cpu().numpy())
    window = min(suggest_window_budget(prof, 0.01), MAX_WINDOW)
    kops = klein_ops if klein_ops is not None else \
        klein_cuda.kernel_operands(pre, dtype=dtype)
    n_pad, dev = kops.n_pad, kops.device
    sp = torch.full((n_pad,), 1e-6, dtype=torch.float64, device=dev)
    sp[:n] = sigmas_prop.to(dev)
    wqt = torch.zeros(n_pad, dtype=torch.float64, device=dev)
    wqt[:n] = 1.0 / (pre.sigmas.to(torch.float64).to(dev) * math.sqrt(2.0))
    ops = SMKOperands(U=kops.U, UT=kops.UT, cse=kops.cs,
                      isgp=(1.0 / sp).to(dtype), wqt=wqt.to(dtype),
                      shift=kops.shift, n=n, window=int(window))
    if dev.type == "cuda":
        ops._tc_fragments = klein_cuda.tc_fragments(kops)
    return ops


# ---------------------------------------------------------------------------
# Plain PyTorch version: the kernel's arithmetic, any device and dtype.
# ---------------------------------------------------------------------------


def _log_normalizer_plain(c, isg, window):
    """log Z of the window around rows of centres c (n, B) with inverse
    widths isg (n, 1): `_draw_row_plain`'s normaliser, the weights of
    `_window_weights_plain` summed in the kernel's sequential order."""
    base = torch.round(c)
    delta = base - c
    a = isg * isg
    nad = (-a) * delta
    m = (-0.5 * a) * (delta * delta)
    total = torch.zeros_like(c)
    for w in _window_weights_plain(nad, a, window):
        total = total + w
    return m + torch.log(total)


def _smk_propose_plain(ops: SMKOperands, rows, out, ct, ctn, centres=None):
    """The SMK sweep into out (n_pad, B): rows draw around
    c_i = ct_i - coupling_i with the proposal widths, ctn_i =
    y_i + coupling_i. Returns the forward sum of log Z_i in float64.
    Padded rows keep the 0 of out and ctn. With `centres` (n_pad, B), row
    i's centre c_i goes to centres[i]."""
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
            coup = t[r] + ops.U[i, i + 1:hi] @ out[i + 1:hi]
            c = ct[i] - coup
            if centres is not None:
                centres[i] = c
            z, logz = _draw_row_plain(c, ops.isgp[i], u[r], ops.window)
            out[i] = z
            ctn[i] = z + coup
            lw += logz.to(torch.float64)
    return lw


def smk_steps_plain(ops: SMKOperands, x, acc, n_steps: int, *,
                    seed: int = 0, step: int = 0, chain_offset: int = 0,
                    uniforms=None, debug: bool = False):
    """Plain version of B4: n_steps SMK steps updating the recentered
    chain-minor state x (n_pad, B) and the acceptance count acc (B,) in
    place. Step s uses Philox step `step + s`. Returns (x, acc, log_alpha
    of the last step); with `debug`, also a dict of the last step's
    proposal `p`, its centres `ctn`, its forward centres `c` and reverse
    centres `cp` (each (n_pad, B), 0 on padded rows) and `lwf`, `lwr`,
    `qn`, `qc`, `log_alpha`."""
    n_pad, B = x.shape
    dt, dev = ops.U.dtype, ops.device
    ct = ops.U @ x
    prop = torch.zeros_like(x)
    ctn = torch.zeros_like(x)
    rows_per_step = n_pad + ACCEPT_ROWS
    la = torch.zeros(B, dtype=dt, device=dev)
    dbg = {}
    for s in range(n_steps):
        rows = _uniform_rows(ops, B, seed, step + s, chain_offset, uniforms,
                             s * rows_per_step)
        if uniforms is not None:
            ua = uniforms[s * rows_per_step + n_pad]
        else:
            ua = philox_uniform(seed, chain_ids(B, chain_offset, dev),
                                step + s, torch.zeros(1, device=dev),
                                TAG_ACCEPT)[0]
        centres = torch.zeros_like(x) if debug else None
        lwf = _smk_propose_plain(ops, rows, prop, ct, ctn, centres)
        # padded rows add exactly 0 (c' = 0 at width 1e-6, wqt = 0)
        n = ops.n
        cp = (ctn[:n] - ct[:n]) + x[:n]
        lwr = _log_normalizer_plain(cp, ops.isgp[:n, None],
                                    ops.window).to(torch.float64).sum(0)
        tn = ops.wqt[:n, None] * (ctn[:n] - ops.cse[:n, None])
        tc = ops.wqt[:n, None] * (ct[:n] - ops.cse[:n, None])
        qn = (tn * tn).to(torch.float64).sum(dim=0)
        qc = (tc * tc).to(torch.float64).sum(dim=0)
        la = ((qc - qn) + (lwf - lwr)).to(dt)
        ua = torch.clamp(ua.to(dt), min=1e-30)
        accept = torch.log(ua) < la
        if debug:
            cpf = torch.zeros_like(x)
            cpf[:n] = cp
            dbg = {"p": prop.clone(), "ctn": ctn.clone(), "c": centres,
                   "cp": cpf, "lwf": lwf, "lwr": lwr, "qn": qn, "qc": qc,
                   "log_alpha": la}
        x.copy_(torch.where(accept[None, :], prop, x))
        ct = torch.where(accept[None, :], ctn, ct)
        acc += accept.to(acc.dtype)
    return (x, acc, la, dbg) if debug else (x, acc, la)


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------

# the proposal tile and the coupling tile are B1's (imhk_tc_common.cuh
# `tc_smem_bytes`), so the largest n_pad is B1's
SMK_TC_MAX_N_PAD = klein_cuda.KLEIN_TC_MAX_N_PAD


def _check_operands(ops: SMKOperands):
    n_pad = ops.n_pad
    if n_pad % klein_cuda.BLOCK:
        raise ValueError(f"n_pad {n_pad} is not a multiple of "
                         f"{klein_cuda.BLOCK}")
    if n_pad > SMK_TC_MAX_N_PAD:
        raise ValueError(
            f"n_pad {n_pad} is above {SMK_TC_MAX_N_PAD}, the largest whose "
            "proposal tile fits a block's shared memory")
    check_cuda("U", ops.U, (n_pad, n_pad))
    check_cuda("UT", ops.UT, (n_pad, n_pad))
    for name in ("cse", "isgp", "wqt"):
        check_cuda(name, getattr(ops, name), (n_pad,))
    if not 1 <= ops.window <= MAX_WINDOW:
        raise ValueError(f"window {ops.window} outside [1, {MAX_WINDOW}]")


def _smk_tc_launch(ops: SMKOperands, x, acc, n_steps: int, seed: int,
                   step: int, chain_offset: int, uniforms, what: str,
                   bad: torch.Tensor, dbg=None):
    """Launch smk_tc.cu's kernel on x (n_pad, B) and acc in place, its C8
    counters into bad (its row of an `ExactGuard`); raise on a launch
    error. Returns
    the last step's log alpha (B,). Does not wait for the kernel."""
    _check_operands(ops)
    B = x.shape[1]
    check_cuda("x", x, (ops.n_pad, B))
    check_cuda("acc", acc, (B,))
    check_cuda("bad", bad, (2,), torch.int32)
    if n_steps < 1:
        raise ValueError(f"n_steps {n_steps} must be >= 1")
    if uniforms is not None:
        check_cuda("uniforms", uniforms,
                   (n_steps * (ops.n_pad + ACCEPT_ROWS), B))
    lib = load("smk_tc")
    frag = klein_cuda.tc_fragments(ops)
    ct0, ct1 = torch.empty_like(x), torch.empty_like(x)
    la = torch.empty_like(acc)
    k0, k1 = seed_key(seed)
    rc = lib.smk_tc_launch(
        ptr(frag), ptr(ops.UT), ptr(ops.cse), ptr(ops.isgp), ptr(ops.wqt),
        ptr(uniforms) if uniforms is not None else None,
        ptr(x), ptr(acc), ptr(ct0), ptr(ct1), ptr(la),
        ptr(dbg) if dbg is not None else None, ptr(bad), ops.n_pad, B,
        ops.window, n_steps, k0, k1, step, chain_offset,
        ctypes.c_void_p(torch.cuda.current_stream(ops.device).cuda_stream))
    raise_on("smk_tc", rc, what)
    return la


def smk_steps(ops: SMKOperands, x, acc, n_steps: int, *, seed: int = 0,
              step: int = 0, chain_offset: int = 0, uniforms=None,
              guard=None):
    """B4: n_steps fused SMK steps in one launch, updating the recentered
    state x (n_pad, B) and acc (B,) (float32 acceptance counts) in place.
    Returns (x, acc, log_alpha of the last step (B,)). With `guard` (an
    `ExactGuard`) the caller checks the C8 counters; without one the
    wrapper checks its own after the launch. CPU operands run
    `smk_steps_plain`."""
    if ops.device.type == "cpu":
        return smk_steps_plain(ops, x, acc, n_steps, seed=seed, step=step,
                               chain_offset=chain_offset, uniforms=uniforms)
    own = guard is None
    if own:
        guard = ExactGuard(ops.device)
    la = _smk_tc_launch(ops, x, acc, n_steps, seed, step, chain_offset,
                        uniforms, "smk_steps", guard.row("smk_steps"))
    count("smk_steps")
    if own:
        guard.check("smk_steps")
    return x, acc, la


def smk_centres_plain(ops: SMKOperands, x, *, seed: int = 0, step: int = 0,
                      chain_offset: int = 0, uniforms=None):
    """Plain version of `smk_centres`: one SMK step (B4's plain version,
    state in place) that also returns its forward centres, reverse centres
    and proposal, each (n_pad, B)."""
    _, _, _, dbg = smk_steps_plain(
        ops, x, torch.zeros(x.shape[1], dtype=x.dtype, device=x.device), 1,
        seed=seed, step=step, chain_offset=chain_offset, uniforms=uniforms,
        debug=True)
    return dbg["c"], dbg["cp"], dbg["p"]


def smk_centres(ops: SMKOperands, x, *, seed: int = 0, step: int = 0,
                chain_offset: int = 0, uniforms=None):
    """B4's debug instantiation: one fused SMK step (state x in place) that
    also writes its forward centres c_i and reverse centres c'_i, as the
    kernel forms them, and its proposal. Returns (centres, reverse centres,
    proposal), each (n_pad, B), recentred. For holding the kernel's own
    centres to float64; not a launch of the main path. CPU operands run
    `smk_centres_plain`."""
    if ops.device.type == "cpu":
        return smk_centres_plain(ops, x, seed=seed, step=step,
                                 chain_offset=chain_offset,
                                 uniforms=uniforms)
    n_pad = ops.n_pad
    dbg = torch.empty(3 * n_pad, x.shape[1], dtype=torch.float32,
                      device=ops.device)
    guard = ExactGuard(ops.device)
    _smk_tc_launch(ops, x, torch.zeros(x.shape[1], device=ops.device), 1,
                   seed, step, chain_offset, uniforms, "smk_centres",
                   guard.row("smk_steps"), dbg=dbg)
    guard.check("smk_centres")
    return dbg[:n_pad], dbg[n_pad:2 * n_pad], dbg[2 * n_pad:]


def smk_tc_resources(n_pad: int, window: int) -> dict:
    """B4's kernel for `window` at n_pad on the current card: registers and
    local (spill) bytes a thread, dynamic shared memory and threads a
    block, and blocks resident per SM."""
    out = (ctypes.c_int * 5)()
    raise_on("smk_tc", load("smk_tc").smk_tc_info(n_pad, window, out),
             "smk_tc_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads"), list(out)))
