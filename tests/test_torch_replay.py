"""Port parity: the decision trace replayed through the port's diffusion
engine on the CPU.

The port's fleet simulator records the golden and the preemption
workloads of ``benchmarks/engine_replay.py``; the port's
``replay_through_engine`` runs their dispatch records through its
``DiffusionSplitEngine`` on the reduced Stable-Diffusion config, and every
structural field of ``BENCH_fleet_sim.json["engine_replay"]`` (the
reference's own run) comes out the same: plans, dispatches, executables,
cache hits, bytes.  Seconds are the hardware's and are never compared.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro.serving import replay as ref_replay
from repro_torch.configs import stable_diffusion_v1
from repro_torch.core.cost_model import CostParams
from repro_torch.core.transport import LOCAL_LINK
from repro_torch.models import diffusion
from repro_torch.serving.engine import DiffusionSplitEngine
from repro_torch.serving.fleet_sim import SimConfig, run_fleet_sim
from repro_torch.serving.replay import (read_trace, replay_through_engine,
                                        verify_decisions)
from repro_torch.serving.simulator import table4_capacity

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = json.loads((ROOT / "BENCH_fleet_sim.json").read_text())[
    "engine_replay"]["cells"]
#: the bench's caps on executed dispatch records
CAPS = {"golden": 60, "preemption": 30}
PREEMPT_CAPACITY = dict(base_count=4, spot_count=8, base_max=8,
                        spot_max=16)
#: report fields the hardware's clock decides
TIMED = ("gpu_seconds", "compile_seconds", "calibration_ratio",
         "max_rel_dev", "groups_within_tol")
GROUP_TIMED = ("measured_s", "ratio", "rel_dev")
#: the structural fields of a group that the bench records
GROUP_KEYS = ("n_scaled", "batch", "n_final", "executions",
              "measured_bytes", "modeled_bytes")


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """The bench's two workloads recorded by the port's simulator."""
    out = {}
    for name, cell in CELLS.items():
        path = tmp_path_factory.mktemp("replay") / f"{name}.jsonl"
        cap = (table4_capacity(**PREEMPT_CAPACITY)
               if name == "preemption" else None)
        run_fleet_sim(SimConfig(trace_out=str(path), capacity=cap,
                                **cell["sim"]))
        out[name] = read_trace(str(path))
    return out


def _untimed(report_json):
    d = {k: v for k, v in report_json.items()
         if k not in TIMED and k != "groups"}
    d["groups"] = [{k: v for k, v in g.items() if k not in GROUP_TIMED}
                   for g in report_json["groups"]]
    return d


@pytest.mark.parametrize("cell", sorted(CAPS))
def test_replay_reproduces_the_bench_cell(traces, cell):
    want = CELLS[cell]
    trace = traces[cell]
    decisions = verify_decisions(trace).to_json()
    assert decisions == want["decisions"]
    assert len(trace.records) == want["trace_records"]
    report = replay_through_engine(trace, max_records=CAPS[cell],
                                   device="cpu").to_json()
    for key, value in want["replay"].items():
        if key in TIMED:
            continue
        if key == "groups":
            assert ([{k: g[k] for k in GROUP_KEYS} for g in report[key]]
                    == [{k: g[k] for k in GROUP_KEYS} for g in value])
        else:
            assert report[key] == value, key
    assert report["measured_executables"] == report["modeled_executables"]
    assert report["measured_hit_rate"] == report["modeled_hit_rate"]
    assert report["gpu_seconds"] > 0 and report["compile_seconds"] > 0


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8", "topk"])
def test_closed_form_wires_reconcile_bytes(traces, wire):
    report = replay_through_engine(traces["golden"], max_records=12,
                                   wire=wire, device="cpu")
    assert report.executed == 12 and report.groups
    for g in report.groups:
        assert g.modeled_bytes > 0
        assert g.measured_bytes == g.modeled_bytes, (wire, g)
    assert report.bytes_overhead == 0.0
    assert report.measured_executables == report.modeled_executables


def test_a_passed_engine_keeps_its_device_and_wire(traces):
    cfg = stable_diffusion_v1.reduced()
    params = diffusion.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu")
    cost = CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=5.0, k_decode=1.0)
    engine = DiffusionSplitEngine(params, cfg, cost, link=LOCAL_LINK,
                                  wire="fp16", device="cpu")
    report = replay_through_engine(traces["golden"], engine=engine,
                                   max_records=3, wire="int8")
    assert engine.wire == "fp16" and engine.device.type == "cpu"
    assert engine.stats["requests"] == report.requests > 0
    fp16 = replay_through_engine(traces["golden"], max_records=3,
                                 wire="fp16", device="cpu")
    assert report.bytes_shipped == fp16.bytes_shipped


def test_replay_asks_for_the_gpu_by_default(traces, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        replay_through_engine(traces["golden"], max_records=1)


def test_replay_matches_the_reference_s(traces):
    """The reference's ``replay_through_engine`` (JAX engine) on the same
    trace: every field but the seconds is equal."""
    trace = traces["golden"]
    ref_trace = ref_replay.Trace(header=trace.header, records=trace.records)
    want = ref_replay.replay_through_engine(ref_trace, max_records=4)
    got = replay_through_engine(trace, max_records=4, device="cpu")
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    assert _untimed(got.to_json()) == _untimed(want.to_json())
    assert got.executed == 4 and got.groups_total >= 1
