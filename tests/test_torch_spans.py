"""The port's spans (`utils/profiling.py` `span`, named `lgm.*`): nothing
is entered while no profiler runs; under `profile_trace` each entry point
writes its span with its stages inside it; the benchmark's readers of the
entry spans count only what lies inside them; and the spans leave the
benchmark's other per-layer metrics as they were."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch import (
    IMHKSampler,
    PeikertSampler,
    lattice_from_basis,
)
from lattice_gaussian_mcmc_tpu_torch.ops.kernels import _build, klein_cuda
from lattice_gaussian_mcmc_tpu_torch.utils import profiling
from lgbench import harness
from lgbench.tests import tiny
from lgbench.trace import Trace

BENCH = harness.Bench()
OLD_METRICS = ("b2_roofline", "b5_roofline", "b7_roofline",
               "offkernel_ms.sample", "offkernel_ms.decode",
               "idle_pct.sample", "idle_pct.decode")
NEW_METRICS = {
    "entry_idle_ms.sample": ("falcon512.imhk_smooth",
                             "falcon1024.imhk_smooth", "falcon512.peikert",
                             "qary64_bkz20.imhk_smooth"),
    "entry_alloc_ms.sample": ("falcon512.imhk_smooth",
                              "falcon1024.imhk_smooth", "falcon512.peikert",
                              "qary64_bkz20.imhk_smooth"),
    "entry_idle_ms.decode": ("falcon512.decode",),
    "entry_alloc_ms.decode": ("falcon512.decode",),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small per-row tensor ops: the thread pool costs more than the work
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _basis4():
    return np.array([[3.0, 1.0, 0.0, 1.0], [0.0, 4.0, 1.0, 0.0],
                     [1.0, 0.0, 3.0, 1.0], [0.0, 1.0, 0.0, 5.0]])


@pytest.fixture(scope="module")
def lat():
    return lattice_from_basis(_basis4(), device="cpu")


# each entry point at a tiny size on the CPU: (span, stages inside it with
# how many of each, the call)
ENTRIES = {
    "sample_iid": (
        "lgm.entry.sample_iid",
        {"lgm.kernel.b1": 1, "lgm.kernel.b2": 3, "lgm.sync.c8_guard": 1,
         "lgm.sync.acceptance": 1, "lgm.layout.coeffs": 1,
         "lgm.layout.points": 1},
        lambda lat: IMHKSampler(lat, 6.0, device="cpu").sample_iid(
            3, 8, n_steps=2 * 64 + 1)),
    "peikert_sample": (
        "lgm.entry.peikert_sample",
        {"lgm.kernel.b5": 1, "lgm.layout.points": 1},
        lambda lat: PeikertSampler(lat, 40.0, device="cpu").sample(3, 8)),
    "nearest_plane": (
        "lgm.entry.nearest_plane",
        {"lgm.operands.babai": 1, "lgm.layout.centres": 1,
         "lgm.layout.recentre": 1, "lgm.kernel.b7": 1,
         "lgm.layout.coeffs": 1},
        lambda lat: lat.nearest_plane(torch.from_numpy(
            np.random.default_rng(5).normal(scale=9.0, size=(8, 4))))),
}


class _Counting:
    """Stands in for `torch.profiler.record_function`, counting entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("lgm.")]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_span_is_entered_without_a_profiler(lat, entry, monkeypatch):
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("lgm.x") is profiling.span("lgm.y")
    assert profiling.span("lgm.x") is profiling._OFF
    ENTRIES[entry][2](lat)
    assert _Counting.entered == 0
    # the same stand-in is what a span enters once a profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("lgm.x"):
            pass
    assert _Counting.entered == 1


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_span_holds_its_stages(lat, entry, tmp_path):
    name, stages, call = ENTRIES[entry]
    with profiling.profile_trace(str(tmp_path)):
        call(lat)
    spans = _spans(tmp_path / "trace.json")
    outer = [e for e in spans if e["name"] == name]
    assert len(outer) == 1
    t0 = float(outer[0]["ts"])
    t1 = t0 + float(outer[0]["dur"])
    inner = [e for e in spans if e["name"] in stages]
    for e in inner:
        assert t0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= t1
        assert e["tid"] == outer[0]["tid"]
    got = {s: sum(1 for e in inner if e["name"] == s) for s in stages}
    assert got == stages


def test_setup_spans(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        lat = lattice_from_basis(_basis4(), device="cpu")
        IMHKSampler(lat, 6.0, device="cpu").sample_iid(1, 4, n_steps=1)
        PeikertSampler(lat, 40.0, device="cpu").sample(1, 4)
    names = [e["name"] for e in _spans(tmp_path / "trace.json")]
    assert names.count("lgm.setup.qr") == 1
    assert names.count("lgm.setup.precompute") == 2
    assert names.count("lgm.setup.burn_in") == 1
    # each sampler's basis limbs at its construction (points_operands),
    # kernel_operands at the first IMHK call, peikert_operands at the
    # first Peikert call (predicted_y is read on a card only)
    assert names.count("lgm.setup.operands") == 4


def test_fragments_span_only_when_it_packs(tmp_path):
    lat = lattice_from_basis(_basis4(), device="cpu")
    ops = klein_cuda.babai_operands(lat.Q, lat.R)
    with profiling.profile_trace(str(tmp_path)):
        first = klein_cuda.tc_fragments(ops)
        again = klein_cuda.tc_fragments(ops)
    assert again is first
    names = [e["name"] for e in _spans(tmp_path / "trace.json")]
    assert names == ["lgm.operands.fragments"]


def test_build_span_only_when_it_opens_a_library(tmp_path, monkeypatch):
    class Lib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "build", lambda name, csrc: "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    csrc = str(tmp_path / "csrc")
    try:
        with profiling.profile_trace(str(tmp_path)):
            first = _build.load("zn", csrc)
            assert _build.load("zn", csrc) is first
    finally:
        _build._LIBS.pop(("zn", csrc), None)
    names = [e["name"] for e in _spans(tmp_path / "trace.json")]
    assert names == ["lgm.setup.build"]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _fixture():
    """Two calls of a window 0-1000 us, each with one entry span, three
    kernels and the runtime's allocation calls inside and outside the
    entry spans."""
    return [
        _x("user_annotation", "lgbench.window", 0.0, 1000.0),
        _x("user_annotation", "lgbench.call", 10.0, 390.0),
        _x("user_annotation", "lgbench.call", 500.0, 400.0),
        _x("kernel", "void lgk::imhk_tc_kernel<16, false, false>(x)",
           50.0, 50.0),
        _x("kernel", "void lgk::peikert_tc_kernel<32>(x)", 150.0, 100.0),
        _x("kernel", "void lgk::klein_tc_kernel<0, false, false, true, "
           "false>(x)", 600.0, 60.0),
        _x("kernel", "void at::native::elementwise_kernel<128, 2>(x)",
           660.0, 40.0),
        _x("cuda_runtime", "cudaFree", 15.0, 12.0),       # mid 21: inside
        _x("cuda_runtime", "cudaMalloc", 30.0, 10.0),     # inside
        _x("cuda_runtime", "cudaLaunchKernel", 45.0, 5.0),
        _x("cuda_runtime", "cudaMallocAsync", 295.0, 15.0),  # mid 302.5
        _x("cuda_runtime", "cudaMalloc", 520.0, 20.0),    # inside
        _x("cuda_runtime", "cudaMemcpyAsync", 530.0, 5.0),
        _x("cuda_runtime", "cudaFree", 900.0, 50.0),      # outside
    ]


def _entries(kind):
    spans = {"sample": ("lgm.entry.sample_iid", "lgm.entry.peikert_sample"),
             "decode": ("lgm.entry.nearest_plane",) * 2}[kind]
    return [_x("user_annotation", spans[0], 20.0, 280.0),
            _x("user_annotation", spans[1], 510.0, 290.0)]


def _ctx(events):
    return SimpleNamespace(trace=Trace({"traceEvents": events}), shapes={
        "n": 16, "window": 8, "chains": 4, "steps": 2, "targets": 4})


def _read(name, ctx):
    return BENCH.module("metrics", name).read(ctx)


@pytest.mark.parametrize("kind", ["sample", "decode"])
def test_entry_metrics_count_only_inside_entry_spans(kind):
    ctx = _ctx(_fixture() + _entries(kind))
    # gaps 0-50, 100-150, 250-600, 700-1000; inside the entry spans 20-300
    # and 510-800: 30 + 50 + 50 + 90 + 100 us, over 2 calls
    assert _read(f"entry_idle_ms.{kind}", ctx) == pytest.approx(0.160)
    # cudaFree 15-27 (12 us) and cudaMalloc 30-40 and 520-540 (10, 20)
    assert _read(f"entry_alloc_ms.{kind}", ctx) == pytest.approx(0.021)
    other = {"sample": "decode", "decode": "sample"}[kind]
    assert _read(f"entry_idle_ms.{other}", ctx) is None
    assert _read(f"entry_alloc_ms.{other}", ctx) is None


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_entry_metrics_read_none_without_entry_spans(name):
    assert _read(name, _ctx(_fixture())) is None
    assert _read(name, SimpleNamespace(trace=None, shapes={})) is None
    decl = [m for m in BENCH.spec["per_layer"] if m["name"] == name]
    assert len(decl) == 1 and decl[0]["layer"] == "entry"
    assert tuple(decl[0]["workloads"]) == NEW_METRICS[name]


def _with_port_spans(events):
    """The fixture with the port's spans on the host and their extents on
    the device, as `torch.profiler` writes them."""
    return events + _entries("sample") + [
        _x("user_annotation", "lgm.kernel.b2", 45.0, 10.0),
        _x("user_annotation", "lgm.layout.points", 100.0, 160.0),
        _x("user_annotation", "lgm.kernel.b7", 560.0, 30.0),
        _x("gpu_user_annotation", "lgm.entry.sample_iid", 50.0, 200.0),
        _x("gpu_user_annotation", "lgm.kernel.b2", 50.0, 50.0),
        _x("gpu_user_annotation", "lgm.kernel.b7", 600.0, 60.0),
        _x("gpu_user_annotation", "lgm.entry.peikert_sample", 600.0, 100.0),
    ]


@pytest.mark.parametrize("name", OLD_METRICS)
def test_port_spans_leave_the_other_metrics_unchanged(name):
    before, after = _ctx(_fixture()), _ctx(_with_port_spans(_fixture()))
    value = _read(name, before)
    assert value is not None
    assert _read(name, after) == value
    assert after.trace.calls == before.trace.calls == 2
    assert after.trace.busy_s() == before.trace.busy_s()
    assert after.trace.device == before.trace.device


def test_idle_gaps_are_named_by_port_spans():
    t = Trace({"traceEvents": _with_port_spans(_fixture())})
    idle = dict(t.breakdown()["idle_gaps"])
    # the gap 100-150 lies in lgm.layout.points, 0-50 has the entry span
    # open at its middle, 25; 250-600 and 700-1000 are the loop's
    assert idle["lgm.layout.points"] == pytest.approx(50e-6)
    assert idle["lgm.entry.sample_iid"] == pytest.approx(50e-6)
    assert idle["lgbench.window"] == pytest.approx(350e-6)
    assert idle["lgbench.call"] == pytest.approx(300e-6)


def test_traced_cpu_run_reports_the_entry_metrics(tmp_path):
    """A traced run of the tiny cells on the CPU (the plain versions, no
    device events, so the whole window is idle) reads the new metrics
    from the port's own spans."""
    root = tiny.make_root(str(tmp_path))
    bench = harness.Bench(root)
    for m in bench.spec["per_layer"]:
        if m["name"].startswith("entry_"):
            m["workloads"] += (["tiny.decode"] if m["name"].endswith(
                ".decode") else ["tiny.imhk", "tiny.peikert"])
    for cell, kind in (("tiny.peikert", "sample"), ("tiny.decode", "decode")):
        r = harness.run(bench, cell, 2 ** 32 + 5, 0.3, True, "cpu",
                        time.perf_counter())
        assert r["correct"], r["checks"]
        idle = r["metrics"][f"entry_idle_ms.{kind}"]["value"]
        assert idle > 0.0
        assert r["metrics"][f"entry_alloc_ms.{kind}"]["value"] == 0.0
        # the window is one gap: the entry spans hold part of it
        window_ms = 1e3 * r["device"]["window_s"]
        assert idle * r["attempted"] < window_ms


@pytest.mark.cuda
def test_entry_spans_reach_the_card(tmp_path):
    """On the card a span that queues work itself is also a
    gpu_user_annotation around that work, on the profiler's clock (the
    device side names the innermost span: the entry spans' kernels go to
    the kernel spans inside them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(64)
    basis = 6.0 * np.eye(64) + np.triu(rng.integers(-2, 3, (64, 64)), 1)
    lat = lattice_from_basis(basis, device="cuda")
    sampler = PeikertSampler(lat, 400.0, device="cuda")
    targets = torch.as_tensor(basis @ rng.integers(-3, 4, (64, 256)),
                              device="cuda").T.contiguous()
    sampler.sample(1, 256)
    lat.nearest_plane(targets)
    torch.cuda.synchronize()
    with profiling.profile_trace(str(tmp_path)):
        sampler.sample(2, 256)
        lat.nearest_plane(targets)
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    gpu = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "gpu_user_annotation"}
    host = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"}
    for name, kernel in (("lgm.kernel.b5", "peikert_tc_kernel"),
                         ("lgm.kernel.b7", "klein_tc_kernel")):
        assert name in gpu, sorted(gpu)
        hits = [e for e in events if e.get("cat") == "kernel"
                and kernel in e["name"]]
        assert len(hits) == 1
        t0 = float(hits[0]["ts"])
        assert gpu[name][0] <= t0 <= gpu[name][1]
    for name, inner in (("lgm.entry.peikert_sample", "lgm.kernel.b5"),
                        ("lgm.entry.nearest_plane", "lgm.kernel.b7")):
        assert host[name][0] <= host[inner][0] <= host[inner][1] \
            <= host[name][1]
