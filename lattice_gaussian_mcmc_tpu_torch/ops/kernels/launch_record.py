"""The kernel wrappers' record of their launches, and hazard C8's guard.

The record holds, for each wrapper by name (`KERNELS`), its launches on
the route it normally takes (`launches`), on klein.cu's FP32 sweep above
the tensor-core sweep's reach (`fp32_launches`, B1, B6 and B7), the
largest |y| its tensor-core kernel drew (`max_abs_y`, the kernels of
`GUARDED`), the chains an SM held at its last launch (`resident_chains`,
B2 and B3) and, of its `launches`, those that `klein_cuda.wide_y` sent to
the WIDE instantiation (`wide_launches`, B1, B2, B3 and B6). Counters that
a kernel keeps on the device (B7's wide coefficients, the points kernel's
limbs) register here by name (`device_counters`). `reset` sets all of it
to 0; `read` returns the record. The kernels of `GUARDED` count hazard C8
into an `ExactGuard`.
"""

from __future__ import annotations

import torch

from lattice_gaussian_mcmc_tpu_torch.utils.profiling import span

KERNELS = ("klein_draw", "klein_draw_centred", "klein_ring", "imhk_fused",
           "imhk_trajectory", "smk_steps", "peikert_rounds", "babai_decode",
           "sample_zn_draws", "points", "hash_to_point", "redraw_uniforms")
# an ExactGuard's rows: B2, B3, B1, B6, centred B1, B4
GUARDED = ("imhk_fused", "imhk_trajectory", "klein_draw", "klein_ring",
           "klein_draw_centred", "smk_steps")
FIELDS = ("launches", "fp32_launches", "max_abs_y", "resident_chains",
          "wide_launches")
EXACT_Y = 256      # |y| up to which the bf16 coupling is exact (hazard C8)

_RECORD: dict = {}
# kernel -> {device: its device counters since the last reset}
_DEVICE: dict = {}


def reset():
    """Set every kernel's record to 0 and drop the device counters."""
    _RECORD.update({k: dict.fromkeys(FIELDS, 0) for k in KERNELS})
    _DEVICE.clear()


def read() -> dict:
    """{kernel: {field: value}} since the last `reset`, a copy."""
    return {k: dict(v) for k, v in _RECORD.items()}


def count(kernel: str, fp32: bool = False, resident_chains=None,
          wide: bool = False):
    """One launch of `kernel` (on klein.cu's FP32 sweep with `fp32`; on
    the WIDE instantiation with `wide`, counted in `launches` too), with
    the chains an SM held at it where given."""
    entry = _RECORD[kernel]
    entry["fp32_launches" if fp32 else "launches"] += 1
    entry["wide_launches"] += bool(wide)
    if resident_chains is not None:
        entry["resident_chains"] = resident_chains


def device_counters(kernel: str, device, size: int, dtype) -> torch.Tensor:
    """`kernel`'s (size,) counters on `device`, zeros at the first call
    after a `reset`; its launches add to them."""
    per = _DEVICE.setdefault(kernel, {})
    if device not in per:
        per[device] = torch.zeros(size, dtype=dtype, device=device)
    return per[device]


def read_device_counters(kernel: str) -> list:
    """`kernel`'s counters on each device since the last `reset`, as lists
    (one synchronisation a device)."""
    return [c.tolist() for c in _DEVICE.get(kernel, {}).values()]


class ExactGuard:
    """Hazard C8's device counters for one entry-point call: the kernels of
    `GUARDED` are exact only while their recentred coefficients are, |y| <=
    EXACT_Y. (len(GUARDED), 2) int32, a row for each, [coefficients with
    |y| > EXACT_Y, largest |y|]. Pass it to every launch of the call, each
    of which counts into its kernel's `row`, then `check` it once before
    the call returns."""

    def __init__(self, device):
        self.counts = torch.zeros(len(GUARDED), 2, dtype=torch.int32,
                                  device=device)

    def row(self, kernel: str) -> torch.Tensor:
        return self.counts[GUARDED.index(kernel)]

    def read(self) -> dict:
        """{kernel: (beyond, largest |y|)}, one synchronisation."""
        return dict(zip(GUARDED, map(tuple, self.counts.tolist())))

    def check(self, what: str):
        """Read the guard once, keep each kernel's largest |y| in the
        record's `max_abs_y`, and raise, naming `what`, if a coefficient
        left the range where the bf16 coupling is exact."""
        with span("lgm.sync.c8_guard"):
            rows = self.read()
        bad = {}
        for kernel, (beyond, top) in rows.items():
            entry = _RECORD[kernel]
            entry["max_abs_y"] = max(entry["max_abs_y"], top)
            if beyond:
                bad[kernel] = beyond
        if bad:
            where = ", ".join(f"{k} {b}" for k, b in bad.items())
            raise RuntimeError(
                f"{what}: {sum(bad.values())} drawn or state coefficients "
                f"have |y| > {EXACT_Y} ({where}), where the bf16 coupling "
                "is no longer exact (hazard C8)")


reset()
