"""The port's `experiments/mesh_scaling.py` on the CPU: its rows at world
size 1 (no group), the payload's keys against the JAX package's, and the
`all_passed` gate, whose card clause is held on stand-in card rows (the
card rows themselves run on the card, in `chip_smoke.py`'s mesh phase).
The CPU-rank curve runs end to end in `tests/test_torch_cli.py`."""

import json

import numpy as np
import pytest
import torch

from lattice_gaussian_mcmc_tpu_torch.experiments import mesh_scaling as ms
from lattice_gaussian_mcmc_tpu_torch.experiments.configs import (
    ExperimentConfig,
)
from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import make_mesh

JAX_KEYS = {"rows", "pallas_rows", "peikert_rows", "process_rows",
            "environment", "physical_cores", "all_passed", "note"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rows_at_world_size_1():
    rows = ms.scaling_rows(make_mesh("cpu"), chains_per_device=16,
                           n_samples=4)
    (r,), (k,), (p,) = rows["rows"], rows["pallas_rows"], rows["peikert_rows"]
    assert (r["impl"], k["impl"], p["impl"]) == (
        "sharded_imhk_chains", "sharded_imhk_blocked", "sharded_peikert")
    assert (r["n_chains"], k["n_chains"], p["n_chains"]) == (16, 256, 256)
    for row in (r, k, p):
        assert row["n_devices"] == 1 and row["device"] == "cpu"
        assert np.isfinite(row["samples_per_sec"])
        assert row["samples_per_sec"] > 0
        # the plain versions run on the CPU: no kernel launch
        assert set(row["launches"].values()) == {0}
    assert 0.0 < r["acceptance"] <= 1.0 and 0.0 < k["acceptance"] <= 1.0
    assert p["pooled_var_max"] > 0.0


def test_card_rows_set_up_and_leave_a_group_of_their_own(tmp_path,
                                                          monkeypatch):
    """card_rows joins a world-size-1 group (gloo for CPU tensors, NCCL
    on a card), runs the rows on it and leaves it; in a process already in
    a group it raises."""
    import torch.distributed as dist
    seen = []

    def rows(mesh, seed=0):
        seen.append((mesh.size, mesh.backend, dist.is_initialized()))
        return {k: [{"n_devices": 1, "samples_per_sec": 2.0}]
                for k in ("rows", "pallas_rows", "peikert_rows")}

    monkeypatch.setattr(ms, "scaling_rows", rows)
    out = ms.card_rows(torch.device("cpu"))
    assert seen == [(1, "gloo", True)] and not dist.is_initialized()
    assert [r["efficiency"] for r in out] == [1.0] * 3
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already in one"):
            ms.card_rows(torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    assert len(seen) == 1


def _fake(card_launches):
    def row(n, impl, **kw):
        return {"n_devices": n, "samples_per_sec": 10.0 * n, "impl": impl,
                **kw}

    def cpu(rank_counts=ms.CPU_RANK_COUNTS, **_):
        return {k: ms._with_efficiency([row(n, impl, acceptance=0.5)
                                        for n in rank_counts])
                for k, impl in (("rows", "sharded_imhk_chains"),
                                ("pallas_rows", "sharded_imhk_blocked"),
                                ("peikert_rows", "sharded_peikert"))}

    def card(device, seed=0):
        return [row(1, "sharded_imhk_chains", acceptance=1.0,
                    launches={"klein_draw": 0, "imhk_fused": 0,
                              "peikert_rounds": 0}),
                row(1, "sharded_imhk_blocked", acceptance=0.9,
                    launches=card_launches),
                row(1, "sharded_peikert", launches=card_launches)]

    def processes(**_):
        return [{"process_count": p, "distributed": p > 1,
                 "samples_per_sec": 5.0} for p in (1, 2)]
    return cpu, card, processes


@pytest.mark.parametrize("launches,passed", [
    ({"klein_draw": 1, "imhk_fused": 1, "peikert_rounds": 1}, True),
    ({"klein_draw": 1, "imhk_fused": 0, "peikert_rounds": 1}, False),
    ({"klein_draw": 1, "imhk_fused": 1, "peikert_rounds": 0}, False),
])
def test_all_passed_needs_the_card_kernel_launches(tmp_path, monkeypatch,
                                                   launches, passed):
    cpu, card, processes = _fake(launches)
    monkeypatch.setattr(ms, "measure_on_cpu_ranks", cpu)
    monkeypatch.setattr(ms, "card_rows", card)
    monkeypatch.setattr(ms, "measure_process_scaling", processes)
    monkeypatch.setattr(ms, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "stand-in")
    out = ms.run_mesh_scaling(ExperimentConfig(output_dir=str(tmp_path)))
    assert out["all_passed"] is passed
    assert set(out) == JAX_KEYS | {"card_rows", "card"}
    assert out["environment"] == "gloo_cpu_ranks"
    assert [r["efficiency"] for r in out["rows"]] == [1.0] * 4
    assert json.loads((tmp_path / "mesh_scaling.json").read_text())[
        "all_passed"] is passed


def test_cpu_run_has_no_card_rows(tmp_path, monkeypatch):
    cpu, _, processes = _fake({})
    monkeypatch.setattr(ms, "measure_on_cpu_ranks", cpu)
    monkeypatch.setattr(ms, "measure_process_scaling", processes)
    out = ms.run_mesh_scaling(ExperimentConfig(output_dir=str(tmp_path)),
                              device="cpu")
    assert out["all_passed"] and out["card_rows"] == []
    assert out["card"] is None


def test_no_card_and_no_cpu_request_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ms.run_mesh_scaling(ExperimentConfig(output_dir=str(tmp_path)))
