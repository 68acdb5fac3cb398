"""Engine-in-the-loop trace replay: execute fleet_sim plans for real.

The simulators validate every scheduling claim against a *model*;
the paper's claims are about a *system* whose split decisions run real
compiled programs.  This module is the bridge (ROADMAP item 1):

1. **Record** — ``SimConfig.trace_out`` makes the fleet simulator write
   a structured JSONL trace of every decision it makes: one ``plan``
   record per arrival (the ``Planner.plan`` decision, serialized via
   ``PlanDecision.to_trace_json``), one ``replan`` record per
   ``Planner.replan_preempted`` / ``Planner.replan_degraded`` decision
   (preemption- and mobility-driven; the latter tagged
   ``source="net-shift"``), one ``dispatch`` record per submitted cloud
   job (the ``(n_final, batch)`` group, its modeled service seconds and
   executing class), one ``preempt`` record per spot reclaim and one
   ``net_shift`` record per applied session network shift
   (serving.mobility).  The header embeds the planner config
   (``Planner.config_json``), so the whole trace is self-describing.

2. **Verify decisions** — ``verify_decisions`` rebuilds the planner from
   the header config and re-derives every recorded decision from its
   recorded inputs (profile + queue/utilization hints; ``n_done`` +
   ``time_left`` for replans).  Every field must match exactly: the
   trace is a deterministic replay log, not a lossy summary
   (``PlanDecision.replay()``'s contract, extended to hot-loop traces
   that carry the config once in the header instead of per decision).

3. **Execute** — ``replay_through_engine`` runs each dispatch record
   through a real ``DiffusionSplitEngine`` executable cache on a small
   config (``configs/stable_diffusion_v1.reduced()``): each distinct
   ``(n_final, batch)`` group becomes a real ``process_group`` call, so
   compile count, cache hit rate, per-group GPU-seconds and bytes
   shipped are *measured*, not assumed.  ``reconcile`` then compares
   them against the simulator's modeled ``service`` seconds and payload
   bytes with a tolerance report (``benchmarks/engine_replay.py`` pins
   the result in ``BENCH_fleet_sim.json["engine_replay"]``).

The sim grid (``n_total=50, n_step=5``) maps onto the reduced engine
grid (``n_total_iterations=10, split_stride=2``) via
``scaled_group_key``: ``n_scaled = quantize_step(n_final * ratio)``.
The map is many-to-one at small n (5 and 10 both land on 2), which is
itself part of the measurement: the *modeled* executable count after
scaling is what the engine's cache must reproduce exactly.

Import cost: this module stays jax-free at import time (the fleet
simulator imports ``TraceWriter`` from here); the engine/model imports
happen inside ``replay_through_engine``.

See docs/engine_replay.md for the schema and how to read the report.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, IO, List, Optional, Tuple

from repro_torch.core.cost_model import quantize_step
from repro_torch.compat import DeviceLike
from repro_torch.core.planner import PlanDecision, Planner, PlanRequest

TRACE_VERSION = 1

#: record kinds a trace may contain, in the order they first appear
TRACE_KINDS = ("header", "plan", "replan", "dispatch", "preempt",
               "net_shift")


# --------------------------------------------------------------------------
# Writer (the fleet simulator's sink)
# --------------------------------------------------------------------------
class TraceWriter:
    """JSONL sink for one fleet-sim run.  One record per line; the first
    line is the self-describing header (planner config + sim metadata).

    The writer is intentionally dumb — every helper below just assembles
    a dict and appends one line, so enabling the trace can never perturb
    simulation state (the golden-trace anchor: ``trace_out=None`` and a
    traced run produce bit-identical event dynamics, pinned in
    tests/test_engine_replay.py).
    """

    def __init__(self, path: str, planner_config: Dict[str, Any],
                 sim_meta: Dict[str, Any]):
        self.path = path
        self._f: Optional[IO[str]] = open(path, "w")
        self.n_records = 0
        self.write({"kind": "header", "version": TRACE_VERSION,
                    "planner": planner_config, "sim": sim_meta})

    def write(self, record: Dict[str, Any]) -> None:
        assert self._f is not None, "trace writer already closed"
        self._f.write(json.dumps(record) + "\n")
        self.n_records += 1

    # -- record constructors (schema in docs/engine_replay.md) -------------
    def plan(self, t: float, request_id: str, profile: Dict[str, Any],
             queue_delay_hint: float, utilization_hint: float,
             decision: PlanDecision) -> None:
        self.write({"kind": "plan", "t": t, "request_id": request_id,
                    "profile": profile,
                    "queue_delay_hint": queue_delay_hint,
                    "utilization_hint": utilization_hint,
                    "decision": decision.to_trace_json()})

    def replan(self, t: float, request_id: str, profile: Dict[str, Any],
               n_done: int, time_left: float, queue_delay_hint: float,
               decision: PlanDecision, source: str = "preempt",
               utilization_hint: float = 0.0) -> None:
        rec = {"kind": "replan", "t": t, "request_id": request_id,
               "profile": profile, "n_done": n_done,
               "time_left": time_left,
               "queue_delay_hint": queue_delay_hint,
               "decision": decision.to_trace_json()}
        if source != "preempt":
            # extra keys only for non-preemption sources, so preemption
            # replan records stay byte-identical to pre-mobility traces
            rec["source"] = source
            rec["utilization_hint"] = utilization_hint
        self.write(rec)

    def net_shift(self, t: float, shift: Dict[str, Any]) -> None:
        """One applied session network shift (mobility.NetShift.to_json);
        informational — ``verify_decisions`` re-derives the *replans* a
        shift causes, the shift record documents why they exist.  The
        shift's own kind (drift/handoff/disconnect/reconnect) lands
        under ``"shift"`` so the record kind stays ``"net_shift"``."""
        rec = dict(shift)
        rec["shift"] = rec.pop("kind")
        rec["kind"] = "net_shift"
        rec["t"] = t
        self.write(rec)

    def dispatch(self, t: float, n_final: int, members: List[str],
                 c_batch: float, gpu_class: str, cloud_rate: float,
                 service: float, deadline: float) -> None:
        self.write({"kind": "dispatch", "t": t, "n_final": n_final,
                    "batch": len(members), "members": members,
                    "c_batch": c_batch, "gpu_class": gpu_class,
                    "cloud_rate": cloud_rate, "service": service,
                    "deadline": deadline})

    def preempt(self, t: float, gpu_class: str, k: int,
                killed_jobs: int) -> None:
        self.write({"kind": "preempt", "t": t, "gpu_class": gpu_class,
                    "k": k, "killed_jobs": killed_jobs})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Trace:
    """One parsed trace: the header plus every record, in file order."""
    header: Dict[str, Any]
    records: List[Dict[str, Any]]

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    def plans(self) -> List[Dict[str, Any]]:
        return self.of_kind("plan")

    def replans(self) -> List[Dict[str, Any]]:
        return self.of_kind("replan")

    def dispatches(self) -> List[Dict[str, Any]]:
        return self.of_kind("dispatch")

    def preempts(self) -> List[Dict[str, Any]]:
        return self.of_kind("preempt")

    def net_shifts(self) -> List[Dict[str, Any]]:
        return self.of_kind("net_shift")

    def planner(self) -> Planner:
        """Rebuild the recording run's planner from the header config."""
        return Planner.from_config(self.header["planner"])


def read_trace(path: str) -> Trace:
    records: List[Dict[str, Any]] = []
    header: Optional[Dict[str, Any]] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind not in TRACE_KINDS:
                raise ValueError(f"unknown trace record kind {kind!r}")
            if kind == "header":
                if header is not None:
                    raise ValueError("trace has multiple header records")
                if rec.get("version") != TRACE_VERSION:
                    raise ValueError(
                        f"trace version {rec.get('version')!r} != "
                        f"{TRACE_VERSION}")
                header = rec
            else:
                records.append(rec)
    if header is None:
        raise ValueError(f"{path}: no header record")
    return Trace(header=header, records=records)


# --------------------------------------------------------------------------
# Decision verification (deterministic re-derivation)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DecisionReplayReport:
    """Did re-planning every recorded decision reproduce the trace?"""
    n_plans: int
    n_replans: int
    mismatches: List[Dict[str, Any]]    # [{"index", "kind", "field", ...}]

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def to_json(self) -> Dict[str, Any]:
        return {"n_plans": self.n_plans, "n_replans": self.n_replans,
                "n_mismatches": len(self.mismatches),
                "ok": self.ok, "mismatches": self.mismatches[:20]}


def _device_from_json(d: Dict[str, Any]):
    from repro_torch.core.telemetry import DeviceProfile
    return DeviceProfile(**d)


def _diff_fields(index: int, kind: str, want: Dict[str, Any],
                 got: Dict[str, Any]) -> List[Dict[str, Any]]:
    # round-trip `got` through JSON so both sides went through the same
    # float repr path (json floats round-trip exactly, so this only
    # normalizes types like inf handling, never values)
    got = json.loads(json.dumps(got))
    return [{"index": index, "kind": kind, "field": k,
             "recorded": want.get(k), "replayed": got.get(k)}
            for k in set(want) | set(got) if want.get(k) != got.get(k)]


def verify_decisions(trace: Trace,
                     max_mismatches: int = 100) -> DecisionReplayReport:
    """Re-derive every recorded plan/replan decision from its recorded
    inputs through a planner rebuilt from the header config, and compare
    field-by-field.

    Adaptive-SLA traces record a drifting ``t_lim`` per decision; the
    verifier applies it through the same ``set_t_lim`` hook the §7
    controller uses, so traces recorded under SLA adaptation verify too.
    """
    planner = trace.planner()
    mismatches: List[Dict[str, Any]] = []
    n_plans = n_replans = 0
    for i, rec in enumerate(trace.records):
        if rec["kind"] == "plan":
            n_plans += 1
            want = rec["decision"]
            if want["t_lim"] != planner.p.t_lim:
                planner.set_t_lim(want["t_lim"], source="replay:trace")
            got = planner.plan_profile(
                _device_from_json(rec["profile"]),
                rec["queue_delay_hint"], rec["utilization_hint"])
        elif rec["kind"] == "replan":
            n_replans += 1
            want = rec["decision"]
            if rec.get("source") == "net-shift":
                # mobility-driven replan (planner.replan_degraded): the
                # shed valve ran, so re-derivation needs the recorded
                # utilization hint too
                got = planner.replan_degraded(
                    PlanRequest(
                        device=_device_from_json(rec["profile"]),
                        request_id=rec["request_id"],
                        queue_delay_hint=rec["queue_delay_hint"],
                        utilization_hint=rec.get("utilization_hint", 0.0)),
                    n_done=rec["n_done"], time_left=rec["time_left"])
            else:
                got = planner.replan_preempted(
                    PlanRequest(device=_device_from_json(rec["profile"]),
                                request_id=rec["request_id"],
                                queue_delay_hint=rec["queue_delay_hint"]),
                    n_done=rec["n_done"], time_left=rec["time_left"])
        else:
            continue
        diffs = _diff_fields(i, rec["kind"], want, got.to_trace_json())
        mismatches.extend(diffs)
        if len(mismatches) >= max_mismatches:
            break
    return DecisionReplayReport(n_plans=n_plans, n_replans=n_replans,
                                mismatches=mismatches)


# --------------------------------------------------------------------------
# Grid scaling: sim (n_total, n_step) -> engine config grid
# --------------------------------------------------------------------------
def scale_n(n_final: int, sim_n_total: int, eng_n_total: int,
            eng_n_step: int) -> int:
    """Map a sim-grid split onto the (smaller) engine config's step grid:
    scale by the iteration-count ratio, then round up to the engine's
    ``split_stride`` grid (the same ``quantize_step`` the planner uses).
    ``n_final <= 0`` (device-only) stays 0.  Many-to-one at small n —
    by design: the scaled distinct-key count is the *modeled*
    executable count the real cache must reproduce."""
    if n_final <= 0:
        return 0
    n = n_final * eng_n_total / sim_n_total
    return quantize_step(n, eng_n_step, eng_n_total)


def scaled_group_key(record: Dict[str, Any], sim_n_total: int,
                     eng_n_total: int, eng_n_step: int
                     ) -> Tuple[int, int]:
    """The engine executable-cache key a dispatch record lands on."""
    return (scale_n(record["n_final"], sim_n_total, eng_n_total,
                    eng_n_step), record["batch"])


# --------------------------------------------------------------------------
# Engine-in-the-loop execution + reconciliation
# --------------------------------------------------------------------------
@dataclasses.dataclass
class GroupStats:
    """Measured-vs-modeled numbers for one distinct (n_scaled, batch)
    executable-cache key."""
    n_scaled: int                 # engine-grid cloud iterations
    batch: int
    n_final: int                  # sim-grid n of the first dispatch seen
    executions: int               # dispatch records replayed on this key
    measured_s: float             # steady-state wall s (min over execs;
                                  # compile time excluded by the engine)
    modeled_s: float              # scaled model: n_scaled*c_batch/(r*ratio)
    measured_bytes: int           # wire payload, per request
    modeled_bytes: int            # split_payload table entry, per request
    ratio: float = 0.0            # measured_s / modeled_s
    rel_dev: float = 0.0          # |ratio/calibration - 1| (reconcile())

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class EngineReplayReport:
    """What actually happened when the trace ran through the engine."""
    n_dispatches: int             # dispatch records in the trace
    executed: int                 # records executed (<= max_records cap)
    skipped: int                  # records dropped by the cap
    device_only: int              # n_final <= 0 plans (no cloud program)
    # executable cache: modeled (pure arithmetic over the trace) vs
    # measured (the engine's own counters)
    modeled_executables: int
    measured_executables: int
    executable_bound: int         # n_total//n_step + 1 (paper claim)
    modeled_cache_hits: int
    measured_cache_hits: int
    measured_cache_misses: int
    modeled_hit_rate: float
    measured_hit_rate: float
    # accounting (engine.stats after the run)
    gpu_seconds: float            # steady-state execution only
    compile_seconds: float        # reported apart from gpu_seconds
    bytes_shipped: int
    requests: int
    # reconciliation
    calibration_ratio: float      # median measured_s / modeled_s
    max_rel_dev: float            # worst per-group deviation from it
    tolerance: float
    groups_within_tol: int
    groups_total: int
    bytes_overhead: float         # measured/modeled wire bytes - 1
    groups: List[GroupStats] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["groups"] = [g.to_json() if isinstance(g, GroupStats)
                       else g for g in self.groups]
        return d


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def reconcile(groups: List[GroupStats],
              tolerance: float = 0.75) -> Tuple[float, float, int]:
    """Fit the single measured/modeled calibration ratio (median over
    distinct keys — the tiny CPU engine and the modeled A100-class rate
    live on different absolute scales) and report each group's relative
    deviation from it.  Returns (calibration_ratio, max_rel_dev,
    n_within_tol) and fills ``ratio``/``rel_dev`` per group.

    The deviation measures whether the engine's *shape* (linear in
    iterations, c_batch batch slowdown) matches the model's; the default
    tolerance is deliberately loose — CPU wall-clock on sub-millisecond
    kernels is noisy, and the bench cell reports the dispersion rather
    than asserting on it.
    """
    for g in groups:
        g.ratio = g.measured_s / g.modeled_s if g.modeled_s > 0 else 0.0
    ratios = [g.ratio for g in groups if g.ratio > 0]
    cal = _median(ratios)
    max_dev = 0.0
    within = 0
    for g in groups:
        g.rel_dev = abs(g.ratio / cal - 1.0) if cal > 0 else math.inf
        max_dev = max(max_dev, g.rel_dev)
        within += g.rel_dev <= tolerance
    return cal, max_dev, within


def replay_through_engine(trace: Trace, engine=None, eng_cfg=None,
                          max_records: Optional[int] = None,
                          tolerance: float = 0.75,
                          seed: int = 0,
                          wire: Optional[str] = None,
                          device: DeviceLike = None) -> EngineReplayReport:
    """Execute the trace's dispatch records through a real
    ``DiffusionSplitEngine`` executable cache and reconcile measured
    warm-up/cache/GPU-seconds/bytes against the modeled numbers.

    ``engine=None`` builds one on the reduced stable-diffusion config
    (CPU-sized) on ``device`` (``None`` = the GPU; a missing GPU raises),
    its weights drawn from ``torch.Generator(device).manual_seed(seed)``;
    pass an engine to reuse warmed executables across calls (that
    *changes* the measured hit rate — it measures the warm cache, not
    this trace).  ``max_records`` caps how many dispatch records execute
    (the report counts what was skipped; nothing is silently dropped).
    ``wire`` names a boundary wire format (``transport.WIRE_FORMATS``)
    for the built engine; a passed-in ``engine`` keeps whatever
    ``engine.wire`` and ``engine.device`` it was constructed with.
    """
    # the engine and model imports live here so the module itself stays
    # light (the fleet simulator imports TraceWriter from this module)
    import numpy as np
    import torch

    from repro_torch.compat import resolve_device
    from repro_torch.configs import stable_diffusion_v1
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.telemetry import DeviceProfile
    from repro_torch.core.transport import LOCAL_LINK
    from repro_torch.models import diffusion
    from repro_torch.serving.engine import DiffusionSplitEngine, Request

    if engine is None:
        dev = resolve_device(device)
        if eng_cfg is None:
            eng_cfg = stable_diffusion_v1.reduced()
        params = diffusion.init_params(
            eng_cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        cost = CostParams(r_cloud=10.0, n_total=eng_cfg.n_total_iterations,
                          n_step=eng_cfg.split_stride, t_lim=5.0,
                          k_decode=1.0)
        engine = DiffusionSplitEngine(params, eng_cfg, cost,
                                      link=LOCAL_LINK, wire=wire, device=dev)
    cfg = engine.cfg
    sim_n_total = int(trace.header["planner"]["params"]["n_total"])
    eng_n_total = cfg.n_total_iterations
    eng_n_step = cfg.split_stride

    payload_table = dict(diffusion.split_payload(cfg, batch=1))
    # wire-format engines (engine.wire set): modeled bytes are the
    # EXACT closed-form encoded size (transport.wire_nbytes — manifest
    # included), so modeled == measured for every non-compressed format.
    # Compressed formats have data-dependent sizes: modeled stays 0 and
    # only the measured side reports (docs/transport.md).
    eng_wire = getattr(engine, "wire", None)

    def modeled_payload_bytes(n_scaled: int) -> int:
        if eng_wire is None:
            return payload_table.get(f"denoising{n_scaled}", 0)
        from repro_torch.core.transport import wire_nbytes
        shapes = {"latent": (cfg.latent_channels, cfg.latent_size,
                             cfg.latent_size)}
        if n_scaled < cfg.n_total_iterations:
            shapes["context"] = (2, cfg.text_len, cfg.text_width)
        try:
            return wire_nbytes(shapes, eng_wire)
        except ValueError:            # data-dependent (compressed) size
            return 0
    dispatches = trace.dispatches()
    cap = len(dispatches) if max_records is None else \
        min(max_records, len(dispatches))
    toks = np.zeros((1, cfg.text_len), np.int32)

    groups: Dict[Tuple[int, int], GroupStats] = {}
    modeled_hits = 0
    for rec in dispatches[:cap]:
        key = scaled_group_key(rec, sim_n_total, eng_n_total, eng_n_step)
        n_scaled, b = key
        if key in groups:
            modeled_hits += 1
        reqs = [Request(rid, DeviceProfile(rid, 1.0), toks, toks)
                for rid in rec["members"]]
        results = engine.process_group(reqs, n_scaled, seed=seed)
        measured_s = sum(r.cloud_seconds for r in results)   # = gpu_s
        measured_bytes = len(results[0].payload)
        g = groups.get(key)
        if g is None:
            # modeled seconds on the ENGINE grid: the recorded service
            # is n_final*c_batch/rate on the sim grid; rescale the
            # iteration count so quantization collisions (two sim
            # groups landing on one engine key) stay comparable
            ratio = eng_n_total / sim_n_total
            modeled_s = (n_scaled * rec["c_batch"]
                         / (rec["cloud_rate"] * ratio))
            groups[key] = GroupStats(
                n_scaled=n_scaled, batch=b, n_final=rec["n_final"],
                executions=1, measured_s=measured_s, modeled_s=modeled_s,
                measured_bytes=measured_bytes,
                modeled_bytes=modeled_payload_bytes(n_scaled))
        else:
            g.executions += 1
            # min over executions: the steadiest steady-state sample
            g.measured_s = min(g.measured_s, measured_s)

    glist = list(groups.values())
    cal, max_dev, within = reconcile(glist, tolerance=tolerance)
    executed = cap
    stats = engine.stats
    total_modeled_bytes = sum(
        g.modeled_bytes * g.batch * g.executions for g in glist)
    meas_hits = stats["cache_hits"]
    meas_misses = stats["cache_misses"]
    return EngineReplayReport(
        n_dispatches=len(dispatches), executed=executed,
        skipped=len(dispatches) - executed,
        device_only=sum(1 for p in trace.plans()
                        if p["decision"]["n_final"] <= 0),
        modeled_executables=len(groups),
        measured_executables=stats["executables"],
        executable_bound=(eng_n_total // eng_n_step + 1),
        modeled_cache_hits=modeled_hits,
        measured_cache_hits=meas_hits,
        measured_cache_misses=meas_misses,
        modeled_hit_rate=modeled_hits / executed if executed else 0.0,
        measured_hit_rate=(meas_hits / (meas_hits + meas_misses)
                           if meas_hits + meas_misses else 0.0),
        gpu_seconds=stats["gpu_seconds"],
        compile_seconds=stats["compile_seconds"],
        bytes_shipped=stats["bytes_shipped"],
        requests=stats["requests"],
        calibration_ratio=cal, max_rel_dev=max_dev, tolerance=tolerance,
        groups_within_tol=within, groups_total=len(glist),
        bytes_overhead=(stats["bytes_shipped"] / total_modeled_bytes - 1.0
                        if total_modeled_bytes else 0.0),
        groups=glist)
