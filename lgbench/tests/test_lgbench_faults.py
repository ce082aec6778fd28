"""A run of the harness, its look for a card skipped, on tiny cells on the
CPU (the kernels' plain versions): sound, it comes out correct; with the
timed path broken underneath in each way the cell can break, `correct`
comes out false. The cells have one card, so no exchange between cards can
be left out."""

import time

import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.ops.kernels import (klein_cuda,
                                                         peikert_cuda)
from lgbench import harness
from lgbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(tiny.make_root(str(tmp_path_factory.mktemp("lg"))))


def run(bench, cell, seed=2 ** 32 + 77):
    return harness.run(bench, cell, seed, 0.6, False, "cpu",
                       time.perf_counter())


def unchanged(ops, x, lw, acc, n_steps, **kw):
    """B2 that returns the chains' state as it found it."""


def half_steps(real):
    def imhk_fused(ops, x, lw, acc, n_steps, **kw):
        h = x.shape[1] // 2
        xh, lwh, acch = x[:, :h].clone(), lw[:h].clone(), acc[:h].clone()
        real(ops, xh, lwh, acch, n_steps, **kw)
        x[:, :h], lw[:h], acc[:h] = xh, lwh, acch
    return imhk_fused


def altered(real):
    def from_kernel_layout(ops, y):
        out = real(ops, y).clone()
        out[:, 0] += 1
        return out
    return from_kernel_layout


def half_rounds(real):
    def peikert_rounds(ops, num_chains, *a, **kw):
        ring = real(ops, num_chains // 2, *a, **kw)
        return torch.cat([ring, torch.zeros_like(ring)], dim=1)
    return peikert_rounds


def altered_ring(real):
    def ring_coeffs(ops, ring):
        out = real(ops, ring).clone()
        out[..., 0] += 1
        return out
    return ring_coeffs


def half_decode(real):
    def babai_decode(ops, ct):
        y = torch.zeros_like(ct)
        h = ct.shape[1] // 2
        y[:, :h] = real(ops, ct[:, :h].contiguous())
        return y
    return babai_decode


def altered_coeffs(real):
    def babai_coeffs(ops, targets):
        out = real(ops, targets).clone()
        out[:, 0] += 1
        return out
    return babai_coeffs


FAULTS = {
    "tiny.imhk": {
        "state unchanged": (klein_cuda, "imhk_fused", lambda real: unchanged),
        "half the batch": (klein_cuda, "imhk_fused", half_steps),
        "answer altered": (klein_cuda, "from_kernel_layout", altered),
    },
    "tiny.peikert": {
        "half the batch": (peikert_cuda, "peikert_rounds", half_rounds),
        "answer altered": (peikert_cuda, "ring_coeffs", altered_ring),
    },
    "tiny.decode": {
        "half the batch": (klein_cuda, "babai_decode", half_decode),
        "answer altered": (klein_cuda, "babai_coeffs", altered_coeffs),
    },
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(bench, cell):
    r = run(bench, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert r["checks"]["rows_differ"]["value"] == 0.0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_broken_path_is_not_correct(bench, cell, fault, monkeypatch):
    mod, name, make = FAULTS[cell][fault]
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    r = run(bench, cell)
    assert not r["correct"], (fault, r["checks"])
    assert r["checks"]["rows_differ"]["value"] > 0.3


def test_failing_call_is_counted(bench, monkeypatch):
    """Calls of the window that raise are counted as failed (the warm-up
    call, which raises in set-up, ends the run)."""
    real, seen = klein_cuda.babai_coeffs, []

    def broken(*a, **k):
        seen.append(1)
        if len(seen) > 1:
            raise RuntimeError("launch failed")
        return real(*a, **k)
    monkeypatch.setattr(klein_cuda, "babai_coeffs", broken)
    r = run(bench, "tiny.decode")
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
