"""Port parity: the port's fleet simulator and its helpers decide exactly
as the reference's do.

The simulator draws with numpy only, so every anchor is compared to the
bit: the golden workload (its digest, p99 and GPU-seconds), a scripted
preemption run, a mobility run, the v2 fast lane, a sharded run in two
spawned processes, the static Table-4 snapshot, and the decision traces
both write, byte for byte.  The SLA controller, the deadline tracker and
the coordinator's fault-tolerance helpers are held to the reference's on
the same inputs.
"""
import dataclasses
import hashlib
import multiprocessing

from repro.core import sla as ref_sla
from repro.serving import fleet_sim as ref_fleet_sim
from repro.serving import mobility as ref_mobility
from repro.serving import simulator as ref_simulator
from repro.train import fault_tolerance as ref_ft
from repro_torch.core import sla
from repro_torch.serving import fleet_sim, mobility, simulator
from repro_torch.train import fault_tolerance as ft

#: tests/test_fleet_sim.py::test_golden_trace's workload
GOLDEN = dict(policy="variable+batching", rate=12.0, duration=40.0,
              seed=7, gpus_init=10, max_gpus=32, metrics_interval_s=10.0)
#: benchmarks/engine_replay.py's scripted spot reclaims on a base+spot pool
PREEMPT = dict(seed=7, rate=10.0, duration=30.0, dispatch="edf",
               preempt_trace=[[10.0, "spot", 4], [18.0, "spot", 3]])
#: tests/test_mobility.py's network-churny configuration
CHURN = dict(policy="variable+batching", rate=20.0, duration=40.0,
             seed=3, gpus_init=6, max_gpus=16, metrics_interval_s=10.0,
             shedding=True)
MOBILE = dict(drift_interval_s=10.0, drift_sigma=0.4, handoff_rate=0.004,
              disconnect_rate=0.002, outage_mean_s=6.0)
#: the v2 fast lane, unsharded and in two cohort shards
V2 = dict(policy="variable+batching", rate=100.0, duration=20.0, seed=7,
          gpus_init=60, max_gpus=200, metrics_interval_s=10.0, core="v2",
          exact_stats=False)

#: every field of a run that the simulation decides (the worker's peak
#: RSS is the host's, not the simulation's)
RESULT_FIELDS = tuple(
    f.name for f in dataclasses.fields(ref_fleet_sim.FleetSimResult)
    if f.name not in ("params", "config", "completed", "stream",
                      "worker_peak_rss_mb"))


def _digest(res):
    sig = hashlib.sha256()
    for c in res.completed:
        sig.update(f"{c.request_id}:{c.completion:.9f}:{c.batched:d};"
                   .encode())
    return sig.hexdigest()[:16]


def _outcome(res):
    out = {name: getattr(res, name) for name in RESULT_FIELDS}
    out["completed"] = [dataclasses.asdict(c) for c in res.completed]
    out["n_completed"] = res.n_completed()
    out["p50"] = res.latency_percentile(50)
    out["p99"] = res.latency_percentile(99)
    out["digest"] = _digest(res)
    return out


def _run_both(tmp_path=None, capacity=None, mobility_kw=None, **kw):
    """The same configuration through both packages; with ``tmp_path``
    each writes its decision trace, returned as bytes."""
    runs = []
    for name, mod, sim, mob in (
            ("ref", ref_fleet_sim, ref_simulator, ref_mobility),
            ("port", fleet_sim, simulator, mobility)):
        cfg = dict(kw)
        if capacity is not None:
            cfg["capacity"] = sim.table4_capacity(**capacity)
        if mobility_kw is not None:
            cfg["mobility"] = mob.MobilityConfig(**mobility_kw)
        trace = None
        if tmp_path is not None:
            trace = tmp_path / f"{name}.jsonl"
            cfg["trace_out"] = str(trace)
        res = mod.run_fleet_sim(mod.SimConfig(**cfg))
        runs.append((res, trace.read_bytes() if trace else None))
    return runs


def test_golden_workload_is_bit_identical(tmp_path):
    (ref, ref_trace), (own, own_trace) = _run_both(tmp_path, **GOLDEN)
    assert _outcome(own) == _outcome(ref)
    # the pinned anchor of tests/test_fleet_sim.py::test_golden_trace
    assert (own.n_arrivals, own.violations,
            round(own.total_gpu_seconds, 9),
            round(own.latency_percentile(99), 9), _digest(own)) == (
        490, 0, 249.312, 8.4873321, "af766f3924e39378")
    assert own_trace == ref_trace and own_trace.count(b"\n") == 798


def test_preemption_run_is_bit_identical(tmp_path):
    cap = dict(base_count=4, spot_count=8, base_max=8, spot_max=16)
    (ref, ref_trace), (own, own_trace) = _run_both(tmp_path, capacity=cap,
                                                   **PREEMPT)
    assert _outcome(own) == _outcome(ref)
    assert own.preempted_gpus > 0 and own.replans > 0
    assert own_trace == ref_trace


def test_mobility_run_is_bit_identical(tmp_path):
    (ref, ref_trace), (own, own_trace) = _run_both(
        tmp_path, mobility_kw=MOBILE, **CHURN)
    assert _outcome(own) == _outcome(ref)
    assert own.net_shifts > 0 and own.net_replans > 0
    assert own_trace == ref_trace


def test_v2_fast_lane_is_bit_identical():
    (ref, _), (own, _) = _run_both(**V2)
    assert own.fast_lane is True
    assert _outcome(own) == _outcome(ref)


def test_sharded_run_in_two_processes_is_bit_identical():
    """Cohort shards in spawned workers: the port's workers import
    ``repro_torch.serving.shard_sim`` by name and leave no child behind."""
    (ref, _), (own, _) = _run_both(shard_cohorts=2, processes=1, **V2)
    port2 = fleet_sim.run_fleet_sim(fleet_sim.SimConfig(
        shard_cohorts=2, processes=2, **V2))
    assert not multiprocessing.active_children()
    assert port2.processes == 2 and len(port2.worker_peak_rss_mb) == 2
    want = _outcome(ref)
    assert _outcome(own) == want
    got = _outcome(port2)
    assert got.pop("processes") == 2 and want.pop("processes") == 1
    assert got == want and len(got["per_shard"]) == 2


def test_table4_snapshot_is_identical():
    ref = ref_simulator.run_table4(n_devices=200, seed=3)
    own = simulator.run_table4(n_devices=200, seed=3)
    assert list(own) == list(ref)
    for name in ref:
        assert dataclasses.asdict(own[name]) == dataclasses.asdict(ref[name])
    assert ([dataclasses.asdict(r) for r in simulator.table4(200, 3)]
            == [dataclasses.asdict(r) for r in ref_simulator.table4(200, 3)])


def test_sla_decisions_are_identical():
    utils = [0.9, 0.95, 0.3, 0.6, 0.1, 0.99, 0.86, 0.2, 0.2, 0.4]
    ctrls = [mod.AdaptiveSLAController(mod.SLAPolicy(t_lim=3.0, t_floor=2.0,
                                                     t_ceil=6.0))
             for mod in (ref_sla, sla)]
    for u in utils:
        assert ctrls[1].update(u) == ctrls[0].update(u)
    trackers = [mod.DeadlineTracker() for mod in (ref_sla, sla)]
    for tr in trackers:
        for i in range(6):
            tr.open(f"r{i}", arrival=0.5 * i, t_lim=3.0)
    for now in (0.0, 1.7, 4.2):
        assert trackers[1].min_slack(now) == trackers[0].min_slack(now)
    for i, done in enumerate((2.0, 3.6, 4.0, 6.5, 4.1, 9.0)):
        assert (trackers[1].close(f"r{i}", done)
                == trackers[0].close(f"r{i}", done))
    assert trackers[1].in_flight() == trackers[0].in_flight() == 0


def test_fault_tolerance_decisions_are_identical():
    results = []
    for mod in (ref_ft, ft):
        clock = [0.0]
        mon = mod.HeartbeatMonitor([f"w{i}" for i in range(6)],
                                   timeout_s=10.0, clock=lambda: clock[0])
        clock[0] = 8.0
        for w in ("w0", "w1", "w2", "w4"):
            mon.beat(w)
        mon.mark_dead("w4")
        clock[0] = 15.0
        dead = mon.check()
        det = mod.StragglerDetector(factor=1.5, window=4)
        for step in range(6):
            for i, w in enumerate(mon.alive):
                det.record(w, 1.0 + 0.1 * i + (1.5 if w == "w2" else 0.0)
                           + 0.01 * step)
        plans = [dataclasses.asdict(mod.plan_elastic_mesh(
            n, model_parallel=mp, chips_per_pod=pod, dropped=dead))
            for n, mp, pod in ((12, 4, 256), (1024, 8, 256), (700, 4, 256),
                               (3, 4, 8))]
        results.append((dead, mon.alive, det.stragglers(), plans))
    assert results[1] == results[0]
    assert results[1][0] == ["w3", "w4", "w5"]
    assert results[1][2] == ["w2"]
