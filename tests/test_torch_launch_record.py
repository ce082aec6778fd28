"""The kernel wrappers' launch record and hazard C8's guard
(`ops/kernels/launch_record.py`) on the CPU: one guard row per kernel,
read once by `check`, which keeps each kernel's largest |y| and raises
naming the call and the kernel; one `reset` for every counter, the device
counters of B7 and the points kernel included; and no counter left on a
wrapper function."""

import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (
    klein_cuda,
    launch_record,
    peikert_cuda,
    points_cuda,
    sign_cuda,
    smk_cuda,
    zn_cuda,
)

WRAPPER_MODULES = (klein_cuda, smk_cuda, peikert_cuda, zn_cuda, sign_cuda,
                   points_cuda)


@pytest.fixture(autouse=True)
def _clean_record():
    launch_record.reset()
    yield
    launch_record.reset()


@pytest.mark.parametrize("kernel", launch_record.GUARDED)
def test_exact_guard_raises_once_read(kernel, monkeypatch):
    """A kernel's row of the guard, set by name: `check` reads the whole
    guard with one `tolist`, keeps that kernel's largest |y| in the record
    (and no other's), and raises when a coefficient left the exact range,
    naming the entry point and the kernel."""
    guard = launch_record.ExactGuard("cpu")
    assert guard.counts.shape == (len(launch_record.GUARDED), 2)
    assert guard.counts.dtype == torch.int32
    reads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(t) or tolist(t))
    guard.row(kernel)[1] = 81
    guard.check("entry")
    assert len(reads) == 1 and reads[0] is guard.counts
    rec = launch_record.read()
    assert rec[kernel]["max_abs_y"] == 81
    assert all(r["max_abs_y"] == 0 for k, r in rec.items() if k != kernel)
    guard.row(kernel)[0] = 3
    with pytest.raises(RuntimeError,
                       match=rf"entry: 3 drawn or state .*\({kernel} 3\).*C8"):
        guard.check("entry")
    assert len(reads) == 2


def test_reset_clears_every_counter():
    """Every field of every kernel and the device counters that B7 and the
    points kernel keep go back to 0 with one `reset`."""
    guard = launch_record.ExactGuard("cpu")
    for kernel in launch_record.KERNELS:
        launch_record.count(kernel, resident_chains=96)
        launch_record.count(kernel, fp32=True)
    for kernel in launch_record.GUARDED:
        guard.row(kernel)[1] = 17
    guard.check("entry")
    launch_record.device_counters("babai_decode", "cpu", 2,
                                  torch.int32)[:] = 300
    launch_record.device_counters("points", "cpu", 5, torch.int64)[:] = 4
    assert klein_cuda.babai_y_stats() == {"beyond_256": 300,
                                          "max_abs_y": 300}
    assert points_cuda.limb_stats()["beyond"] == 4
    rec = launch_record.read()
    assert all(r["launches"] == r["fp32_launches"] == 1 for r in rec.values())
    assert all(rec[k]["max_abs_y"] == 17 for k in launch_record.GUARDED)
    launch_record.reset()
    rec = launch_record.read()
    assert set(rec) == set(launch_record.KERNELS)
    assert all(v == 0 for r in rec.values() for v in r.values())
    assert klein_cuda.babai_y_stats() == {"beyond_256": 0, "max_abs_y": 0}
    assert points_cuda.limb_stats() == dict.fromkeys(
        ("limbs_1", "limbs_2", "limbs_3", "limbs_4", "beyond"), 0)
    assert launch_record.device_counters(
        "points", "cpu", 5, torch.int64).tolist() == [0] * 5


def test_read_is_a_copy():
    rec = launch_record.read()
    rec["klein_draw"]["launches"] = 5
    assert launch_record.read()["klein_draw"]["launches"] == 0


@pytest.mark.parametrize("kernel", launch_record.KERNELS)
def test_wrappers_carry_no_counters(kernel):
    """Each name of the record is a wrapper of the ops layer, and the
    wrapper keeps no count of its own."""
    wrappers = [getattr(m, kernel) for m in WRAPPER_MODULES
                if hasattr(m, kernel)]
    assert len(wrappers) == 1 and callable(wrappers[0])
    assert not any(hasattr(wrappers[0], f) for f in launch_record.FIELDS)


def test_runtime_window_launches_count_the_w0_instantiation():
    """`runtime_window_launches` counts, of a kernel's launches, those at a
    window its library does not compile; they are launches too, and a
    reset clears them."""
    launch_record.count("klein_draw", runtime_window=True)
    launch_record.count("imhk_fused", resident_chains=128, wide=True,
                        runtime_window=True)
    launch_record.count("imhk_fused", resident_chains=256)
    launch_record.count("klein_ring", fp32=True)
    rec = launch_record.read()
    assert all("runtime_window_launches" in r for r in rec.values())
    assert (rec["klein_draw"]["launches"],
            rec["klein_draw"]["runtime_window_launches"]) == (1, 1)
    assert (rec["imhk_fused"]["launches"],
            rec["imhk_fused"]["runtime_window_launches"],
            rec["imhk_fused"]["wide_launches"]) == (2, 1, 1)
    assert rec["klein_ring"]["runtime_window_launches"] == 0
    assert sum(r["runtime_window_launches"] for r in rec.values()) == 2
    launch_record.reset()
    assert all(r["runtime_window_launches"] == 0
               for r in launch_record.read().values())
