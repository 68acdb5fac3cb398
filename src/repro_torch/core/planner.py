"""Unified Planner API: one request/decision protocol for every split,
batching, and capacity decision.

The paper's core contribution (§5) is a scheduler that "collects
information about network quality, client device capability, and job
requirements" and makes ONE decision per request.  Pre-refactor, that
decision was assembled ad hoc by every consumer from scattered pieces
(``cost_model.solve_n_cloud``, ``scheduler.assign_one`` /
``cheapest_feasible_class``, ``admission.BatchingAdmission``,
``capacity.CloudCapacity``, ``sla``).  This module is the single seam:

    PlanRequest  (DeviceProfile + NetworkProfile + job context)
        -> Planner.plan(): a composable policy pipeline
           split solve -> quantize -> class routing -> batching
           admission -> load shedding -> SLA adaptation
        -> PlanDecision (JSON-serializable, with an explain() trace
           naming the policy that set each field, and deterministic
           replay from the serialized form)

Design contract (the golden-trace anchor): the pipeline DELEGATES to
the exact scheduler / admission / routing objects the pre-planner code
paths used, so a migrated consumer produces bit-identical numbers.  The
legacy free functions remain as thin delegates around this module.

JointDNN and LinguaLinked both converge on this shape — a profile-in /
plan-out interface is what lets offloading policies be swapped and
compared cleanly; it is also the seam the ROADMAP's multi-pod serving
and spot-preemption items plug into.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.admission import BatchingAdmission
from repro_torch.core.capacity import CloudCapacity, GpuClass
import numpy as np

from repro_torch.core.cost_model import (
    BatchModel,
    CostParams,
    c_batch_at,
    cloud_gpu_time,
    e2e_latency,
    e2e_latency_batch,
    quantize_step_batch,
    solve_n_cloud_batch,
)
from repro_torch.core.scheduler import (
    AllCloudScheduler,
    Assignment,
    ConstantIterationScheduler,
    IntelligentBatchingScheduler,
    SchedulerBase,
    VariableIterationScheduler,
    cheapest_feasible_class,
)
from repro_torch.core.telemetry import DeviceProfile
from repro_torch.core.transport import WIRE_FORMATS, WireFormat, WirePolicy

#: The four Table-4 policies, in paper order (canonical definition;
#: ``serving.simulator.POLICIES`` re-exports it).
POLICIES = ("all_cloud", "constant", "variable", "variable+batching")

#: iPhone 12 mini (paper §5.4) — the default worst device the constant
#: policy sizes for.
SLOWEST_DEVICE = 1.44

DISPATCH_MODES = ("fifo", "edf")


def make_scheduler(name: str, params: CostParams,
                   worst_r_dev: float = SLOWEST_DEVICE,
                   worst_rtt: float = 0.3, batch_size: int = 2,
                   batch_model: Optional[BatchModel] = None,
                   solve_c_batch: float = 1.0) -> SchedulerBase:
    """Single factory for the Table-4 policies — every surface (the
    planner, the static snapshot path, the event-driven fleet simulator)
    builds its per-request assignment logic here, so they can never
    drift apart.  ``solve_c_batch`` applies to the "variable" policy
    only: the slowdown its solve assumes (see
    ``VariableIterationScheduler``)."""
    if name == "all_cloud":
        return AllCloudScheduler(params)
    if name == "constant":
        return ConstantIterationScheduler(params, worst_r_dev=worst_r_dev,
                                          worst_rtt=worst_rtt)
    if name == "variable":
        return VariableIterationScheduler(params,
                                          solve_c_batch=solve_c_batch)
    if name == "variable+batching":
        return IntelligentBatchingScheduler(params, c_batch=params.c_batch,
                                            batch_size=batch_size,
                                            batch_model=batch_model)
    raise ValueError(f"unknown policy {name!r}; expected one of {POLICIES}")


# --------------------------------------------------------------------------
# Request side: device + network + job requirements
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    """Measured network quality for one request (overrides whatever the
    device profile last reported)."""
    rtt: float                    # round trip, seconds
    bandwidth: float = 12.5e6     # bytes/s

    @classmethod
    def from_link(cls, link) -> "NetworkProfile":
        """Adapt a ``core.transport.LinkProfile`` (duck-typed: anything
        with .rtt and .bandwidth)."""
        return cls(rtt=link.rtt, bandwidth=link.bandwidth)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Job requirements: what the service needs, independent of which
    cloud runs it (r_cloud comes from the capacity at plan time)."""
    n_total: int = 50             # iterations for full quality
    n_step: int = 5               # quantization step (batchable groups)
    t_lim: float = 8.5            # SLA: max end-to-end latency, seconds
    k_decode: float = 2.0         # decode cost scale (paper §4.3)
    c_batch: float = 1.6          # batch-2 slowdown measurement (§4.4)
    policy: str = "variable+batching"
    batch_size: int = 2
    #: real multi-point batch timings ((batch_size, seconds), ...); when
    #: given, ``fit_batch_model`` calibrates the batching slope instead
    #: of the single pinned ``c_batch_at`` extrapolation
    batch_timings: Optional[Tuple[Tuple[int, float], ...]] = None
    #: accuracy budget the wire stage may spend on boundary quantization
    #: (``WireFormat.error`` units; docs/transport.md).  0.0 — the
    #: default — pins the wire format to fp32 (bit-identical planning).
    error_budget: float = 0.0

    def cost_params(self, r_cloud: float) -> CostParams:
        return CostParams(r_cloud=r_cloud, n_total=self.n_total,
                          n_step=self.n_step, t_lim=self.t_lim,
                          k_decode=self.k_decode, c_batch=self.c_batch)

    @classmethod
    def from_params(cls, p: CostParams, policy: str = "variable+batching",
                    batch_size: int = 2,
                    batch_timings=None) -> "JobSpec":
        return cls(n_total=p.n_total, n_step=p.n_step, t_lim=p.t_lim,
                   k_decode=p.k_decode, c_batch=p.c_batch, policy=policy,
                   batch_size=batch_size,
                   batch_timings=tuple(tuple(x) for x in batch_timings)
                   if batch_timings else None)

    def batch_model(self) -> Optional[BatchModel]:
        if not self.batch_timings:
            return None
        return BatchModel.from_timings(self.batch_timings)


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One request in: who is asking (device), over what network, and
    how backed up the cloud currently looks (``queue_delay_hint`` — the
    §4.4 online admission honesty term — plus ``utilization_hint``, the
    observed pool utilization the load-shedding stage watches)."""
    device: DeviceProfile
    network: Optional[NetworkProfile] = None
    queue_delay_hint: float = 0.0
    utilization_hint: float = 0.0
    request_id: str = ""

    def profile(self) -> DeviceProfile:
        """The merged device view the solver sees: live network
        measurements override the profile's last-reported ones."""
        if self.network is None:
            return self.device
        return dataclasses.replace(self.device, rtt=self.network.rtt,
                                   bandwidth=self.network.bandwidth)

    def to_json(self) -> Dict[str, Any]:
        return {
            "device": dataclasses.asdict(self.device),
            "network": dataclasses.asdict(self.network)
            if self.network else None,
            "queue_delay_hint": self.queue_delay_hint,
            "utilization_hint": self.utilization_hint,
            "request_id": self.request_id,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "PlanRequest":
        return cls(
            device=DeviceProfile(**d["device"]),
            network=NetworkProfile(**d["network"]) if d.get("network")
            else None,
            queue_delay_hint=d.get("queue_delay_hint", 0.0),
            utilization_hint=d.get("utilization_hint", 0.0),
            request_id=d.get("request_id", ""),
        )


# --------------------------------------------------------------------------
# Decision side
# --------------------------------------------------------------------------
#: The audit-invariant VALUE subset of a PlanDecision that trace records
#: carry (serving.replay).  Deliberately excludes ``gpu_class`` /
#: ``cloud_rate`` (advisory routing runs only in audit mode, so they
#: differ between a hot-loop recording and an audited re-derivation) and
#: the audit payloads (``trace``/``request``/``planner`` — the trace
#: header carries the config once instead of per decision).  Everything
#: here is pinned value-identical across audit modes and across the
#: cached/uncached paths, which is what makes field-exact replay
#: verification possible.
TRACE_FIELDS = ("n_exact", "n_final", "latency", "feasible", "gpu_time",
                "batch_admit", "batch_max_wait", "t_lim", "action", "wire")


@dataclasses.dataclass
class PlanDecision:
    """One decision out: everything every consumer needs, plus the
    trace of which policy set each field, plus the planner + request
    context needed to replay the decision deterministically from its
    serialized form (telemetry)."""
    request: Dict[str, Any]       # serialized PlanRequest
    planner: Dict[str, Any]       # serialized planner config (replay)
    n_exact: float                # real-valued split solve
    n_final: int                  # after step quantization
    latency: float                # predicted e2e at the reference rate
    feasible: bool                # latency <= t_lim
    gpu_time: float               # predicted cloud GPU-seconds (solo)
    gpu_class: Optional[str]      # advisory cheapest feasible class
    cloud_rate: float             # r_cloud of that class (ref if None)
    batch_admit: bool             # §4.4: may wait in a batching window
    batch_max_wait: float
    batch_latency: float          # predicted no-wait latency, batched rate
    batch_solo_latency: float
    batch_reason: str
    t_lim: float                  # effective SLA this was decided under
    trace: List[Dict[str, Any]]   # [{"field", "value", "policy", "detail"}]
    #: admission verdict of the load-shedding stage: "admit" (serve the
    #: plan as solved), "degrade-to-local" (pressure: n_final forced to
    #: 0, the device runs everything), or "reject" (pressure AND no
    #: winnable plan — not even pure-local meets the deadline)
    action: str = "admit"
    shed_reason: str = ""
    #: boundary wire format the payload ships in (docs/transport.md);
    #: "fp32" — dense, no codec — unless a wire stage with a positive
    #: error budget picked a cheaper encoding for this link
    wire: str = "fp32"

    #: the live Assignment the scheduler produced (not serialized; the
    #: fleet simulator keeps it so the migration is object-identical)
    _assignment: Optional[Assignment] = dataclasses.field(
        default=None, repr=False, compare=False)

    def assignment(self) -> Assignment:
        """Legacy bridge: the ``scheduler.Assignment`` view of this
        decision (the object the scheduler produced when planned live,
        reconstructed bit-exactly after deserialization)."""
        if self._assignment is not None:
            return self._assignment
        if not self.request:
            raise ValueError(
                "decision carries no request payload (planned with "
                "audit=False): reconstruct from the live Assignment or "
                "re-plan with an audited Planner")
        req = PlanRequest.from_json(self.request)
        prof = req.profile()
        return Assignment(
            device_id=prof.device_id, r_dev=prof.r_dev,
            t_network=prof.rtt, n_exact=self.n_exact,
            n_final=self.n_final, latency=self.latency,
            feasible=self.feasible)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["_assignment"]
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "PlanDecision":
        return cls(**{k: v for k, v in d.items() if k != "_assignment"})

    def to_trace_json(self) -> Dict[str, Any]:
        """The compact audit-invariant value record a replay trace
        stores per decision (see TRACE_FIELDS for what is excluded and
        why) — shared by audited and hot-loop decisions alike."""
        return {k: getattr(self, k) for k in TRACE_FIELDS}

    def replay(self) -> "PlanDecision":
        """Rebuild the planner from the embedded config and re-plan the
        embedded request.  Deterministic: ``replayed.to_json() ==
        self.to_json()`` (tested)."""
        if not self.planner or not self.request:
            raise ValueError(
                "decision carries no replay payload (planned with "
                "audit=False — audit payloads are skipped in hot-loop "
                "mode); plan with an audited Planner to replay")
        return Planner.from_config(self.planner).plan(
            PlanRequest.from_json(self.request))

    def explain(self) -> str:
        """Human-readable trace: which policy set each field and why."""
        lines = []
        for e in self.trace:
            val = e["value"]
            val = f"{val:.6g}" if isinstance(val, float) else repr(val)
            line = f"{e['field']:>18s} = {val:<14s} <- {e['policy']}"
            if e.get("detail"):
                line += f"  ({e['detail']})"
            lines.append(line)
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Queue-aware class routing (the dispatch-time policy)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PoolSnapshot:
    """What routing needs to know about one class's pool right now."""
    free: bool                    # busy < capacity (a GPU is idle)
    queue_delay: float            # estimated wait for a newly queued job
    routable: bool                # capacity + pending > 0


class RoutePolicy:
    """Class-routing rule shared by the planner and the fleet
    simulator's ``HeterogeneousDispatcher`` (which delegates here
    instead of inlining the loop).

    ``deadline_aware=True`` ("edf" dispatch): a job goes to the CHEAPEST
    class whose estimated finish (queue estimate + per-class service
    time) still meets its cloud deadline; when none is feasible, to the
    class finishing soonest.  ``deadline_aware=False`` ("fifo"): first
    class (cheapest order) with a free GPU, else soonest-finish — the
    deadline-blind baseline.

    This is the queue-state-aware sibling of the pure model-level
    ``scheduler.cheapest_feasible_class`` (which the planner's advisory
    routing stage uses); both walk ``capacity.cheapest_first()``.
    """

    def __init__(self, capacity: CloudCapacity, params: CostParams,
                 deadline_aware: bool = False):
        self.capacity = capacity
        self.p = params
        self.deadline_aware = deadline_aware
        self.order = capacity.cheapest_first()
        self.name = ("route:edf-cheapest-feasible" if deadline_aware
                     else "route:first-free")

    def service_on(self, cls: GpuClass, n_final: int,
                   batch_factor: float) -> float:
        """Wall seconds one job holds a GPU of ``cls``."""
        return cloud_gpu_time(n_final, self.p, batch_factor,
                              r_cloud=cls.r_cloud)

    def choose(self, now: float, n_final: int, batch_factor: float,
               deadline: float,
               pools: Mapping[str, PoolSnapshot]) -> GpuClass:
        """Pick the executing class given live per-class queue state.

        Classes with no capacity and none pending are never routable — a
        job queued there would strand forever (jobs stay in their routed
        class's queue, and the spot-first autoscaler may never grow that
        class).
        """
        best, best_finish = None, math.inf
        for cls in self.order:
            snap = pools[cls.name]
            if not snap.routable:
                continue
            service = self.service_on(cls, n_final, batch_factor)
            start = now if snap.free else now + snap.queue_delay
            finish = start + service
            if self.deadline_aware:
                if finish <= deadline + 1e-9:
                    return cls
            elif snap.free:
                return cls
            if finish < best_finish:
                best, best_finish = cls, finish
        if best is not None:
            return best
        # every pool is empty with nothing pending (possible at t=0 with
        # autoscale on): queue where the spot-first autoscaler will grow
        # capacity first
        for cls in self.capacity.scale_order():
            if cls.max_count > 0:
                return cls
        return self.order[0]


# --------------------------------------------------------------------------
# Admission-level load shedding (the pipeline's pressure valve)
# --------------------------------------------------------------------------
#: The three load-shedding verdicts, in decreasing order of service.
PLAN_ACTIONS = ("admit", "degrade-to-local", "reject")


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """When does the admission stage start shedding load?

    Pressure is declared when the caller-supplied hints cross either
    threshold: ``queue_delay_hint > queue_high * t_lim`` (the cloud
    backlog alone would eat that fraction of the latency budget) or
    ``utilization_hint >= util_high`` (the pool is saturated; queueing
    theory says delay is about to explode).  Under pressure, a request
    whose queued cloud plan still fits ``t_lim`` is admitted; one whose
    cloud plan would violate DEGRADES to pure-local service if the
    device can finish within ``degrade_ceil * t_lim`` (§7's graceful
    degradation: serve late locally, free the cloud); only a request
    with no winnable plan either way is rejected.  A request whose
    pure-local latency meets its deadline is therefore NEVER rejected
    (``degrade_ceil >= 1``; property-tested:
    ``test_shedding_never_rejects_local_feasible_*``).
    """
    queue_high: float = 0.6       # fraction of t_lim the queue may eat
    util_high: float = 0.95       # utilization at/above this is pressure
    degrade_ceil: float = 1.5     # local service may take this x t_lim

    def __post_init__(self):
        if self.queue_high <= 0 or not (0.0 < self.util_high <= 1.0 + 1e-9):
            raise ValueError("need queue_high > 0 and 0 < util_high <= 1")
        if self.degrade_ceil < 1.0:
            raise ValueError("degrade_ceil must be >= 1.0 (otherwise a "
                             "locally-FEASIBLE request could be rejected)")

    def pressured(self, request: "PlanRequest", t_lim: float) -> bool:
        return self.pressured_hints(request.queue_delay_hint,
                                    request.utilization_hint, t_lim)

    def pressured_hints(self, queue_delay_hint: float,
                        utilization_hint: float, t_lim: float) -> bool:
        """The same predicate on bare hints (the planner's cached hot
        path carries hints without a PlanRequest wrapper)."""
        return (queue_delay_hint > self.queue_high * t_lim
                or utilization_hint >= self.util_high)


# --------------------------------------------------------------------------
# Plan memoization (the hot-loop cache behind Planner.plan)
# --------------------------------------------------------------------------
class _PlanEntry:
    """Memoized profile-dependent intermediates of one pipeline run:
    the split solve + quantization (``asg``), the solo GPU time, the
    §4.4 admission latencies, and the pure-local latency the shedding
    stage compares against.  The hint-dependent stages (admission
    verdict, shedding) are re-run per request from these — so cached
    decisions are bit-identical to pipeline decisions by construction.

    ``last_decision`` additionally memoizes the fully assembled decision
    for the previous (queue, utilization) hints: steady-state traffic
    with an empty queue repeats (0.0, 0.0) and skips even the assembly.
    """

    __slots__ = ("epoch", "asg", "gpu_time", "has_admission", "solo",
                 "batched", "local_lat", "deny_slack", "wire",
                 "deny_decision", "last_qhint", "last_uhint",
                 "last_device_id", "last_decision")

    def __init__(self, epoch: int, asg: Assignment, gpu_time: float,
                 has_admission: bool, solo: float, batched: float,
                 local_lat: float, deny_slack: float,
                 wire: str = "fp32"):
        self.epoch = epoch
        self.asg = asg
        self.wire = wire
        self.gpu_time = gpu_time
        self.has_admission = has_admission
        self.solo = solo
        self.batched = batched
        self.local_lat = local_lat
        #: queue hints >= this slack all produce the SAME decision
        #: (admission denies with max_wait=0 and nothing else reads the
        #: hint), memoized as ``deny_decision``.  -inf when admission is
        #: impossible for this profile: then EVERY un-pressured hint
        #: shares the one decision.
        self.deny_slack = deny_slack
        self.deny_decision: Optional["PlanDecision"] = None
        self.last_qhint = math.nan       # never equal: first hit assembles
        self.last_uhint = math.nan
        self.last_device_id = ""
        self.last_decision: Optional["PlanDecision"] = None


class PlanCache:
    """Memoizes ``Planner.plan`` across requests with the same device
    profile — the fleet case: a production fleet has FEW distinct
    (r_dev, rtt, bandwidth) profiles, so after warm-up every arrival is
    an O(1) lookup instead of a split/quantize/admission/shed pipeline
    run (the same redundant-work observation JointDNN makes for its
    per-device offline profiles).

    Keys are the decision-relevant ``DeviceProfile`` fields — EXACT by
    default, so a hit replays precisely the inputs it was computed from
    and cached == uncached is guaranteed bit-identical (property-tested).
    ``quanta=(dr, drtt, dbw)`` opts into approximate bucketing of the
    continuous fields for noisy live telemetry (trades exactness for hit
    rate; never used by the simulator's golden-trace configs).

    Invalidation is epoch-based: the owning planner bumps
    ``config_epoch`` on every decision-relevant mutation (``set_t_lim``,
    ``set_capacity``, ``set_shed_policy``) and stale entries miss.
    Entries are evicted FIFO beyond ``max_entries``.  Decisions returned
    from the cache are SHARED objects — callers must treat them (and
    their assignments) as read-only, which every repo consumer does.
    """

    def __init__(self, max_entries: int = 4096,
                 quanta: Optional[Tuple[float, float, float]] = None):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.max_entries = max_entries
        self.quanta = quanta
        self._entries: Dict[tuple, _PlanEntry] = {}
        self.hits = 0                 # profile entry reused (solve skipped)
        self.misses = 0               # full pipeline ran

    def key_for(self, prof: DeviceProfile) -> tuple:
        # NOTE: the quanta-None return below is inlined in
        # Planner.plan_profile (hot path) — change both together (a
        # lockstep test pins their equality)
        r_dev, rtt, bw = prof.r_dev, prof.rtt, prof.bandwidth
        if self.quanta is not None:
            dr, drtt, dbw = self.quanta
            if dr > 0:
                r_dev = round(r_dev / dr) * dr
            if drtt > 0:
                rtt = round(rtt / drtt) * drtt
            if dbw > 0:
                bw = round(bw / dbw) * dbw
        return (r_dev, rtt, bw, prof.k_decode, prof.has_accelerator)

    def store(self, key: tuple, entry: _PlanEntry) -> None:
        entries = self._entries
        if len(entries) >= self.max_entries and key not in entries:
            del entries[next(iter(entries))]
        entries[key] = entry

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


# --------------------------------------------------------------------------
# The planner
# --------------------------------------------------------------------------
def _t(field: str, value, policy: str, detail: str = "") -> Dict[str, Any]:
    return {"field": field, "value": value, "policy": policy,
            "detail": detail}


class Planner:
    """The one decision-maker: PlanRequest in, PlanDecision out.

    The pipeline stages and the policy objects behind them:

    1. split solve      — ``make_scheduler(policy).assign_one`` (the
                          Table-4 per-request solvers)
    2. quantize         — the same assignment's n_step rounding
    3. class routing    — ``cheapest_feasible_class`` over the capacity
                          (advisory; the queue-aware ``route_policy`` is
                          what a dispatcher consults at submit time)
    4. batching         — ``admission.BatchingAdmission`` (§4.4 online)
    5. load shedding    — ``ShedPolicy`` pressure valve: admit /
                          degrade-to-local / reject (``decision.action``;
                          no-op when ``shed_policy`` is None)
    6. SLA adaptation   — the effective t_lim (``set_t_lim`` is the
                          hook the §7 adaptive controller drives)

    The scheduler and admission objects are owned by the planner and
    shared with any consumer that needs them live (the fleet simulator),
    so there is exactly one source of truth per decision.

    ``audit`` (default True) controls whether plan() materializes the
    audit payloads — the per-field trace and the embedded request +
    planner config that make a decision explainable and replayable.
    ``audit=False`` is for embedded hot loops (the fleet simulator makes
    thousands of decisions per run and discards everything but three
    scalars): the SAME pipeline runs and every decision VALUE is
    identical, but trace/request/planner come back empty, so such
    decisions are not replayable and skip the advisory class route.
    """

    def __init__(self, params: Optional[CostParams] = None, *,
                 job: Optional[JobSpec] = None,
                 capacity: Optional[CloudCapacity] = None,
                 policy: Optional[str] = None,
                 batch_size: Optional[int] = None,
                 batch_model: Optional[BatchModel] = None,
                 worst_r_dev: float = SLOWEST_DEVICE,
                 worst_rtt: float = 0.3,
                 dispatch: str = "fifo",
                 solve_c_batch: float = 1.0,
                 audit: bool = True,
                 sla_source: str = "fixed",
                 shed_policy: Optional[ShedPolicy] = None,
                 cache: object = True,
                 wire: Optional[WirePolicy] = None):
        if params is None:
            if job is None:
                raise ValueError("need params or a JobSpec")
            if capacity is None:
                raise ValueError("JobSpec carries no r_cloud: pass the "
                                 "capacity that will run the job")
            params = job.cost_params(capacity.reference_rate())
        if job is None:
            job = JobSpec.from_params(
                params, policy=policy or "variable+batching",
                batch_size=batch_size or 2)
        self.job = job
        self.policy = policy if policy is not None else job.policy
        self.batch_size = batch_size if batch_size is not None \
            else job.batch_size
        if dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch {dispatch!r}; "
                             f"expected one of {DISPATCH_MODES}")
        self.dispatch = dispatch
        self.capacity = capacity
        self.worst_r_dev = worst_r_dev
        self.worst_rtt = worst_rtt
        self.batch_model = batch_model if batch_model is not None \
            else job.batch_model()
        self.p = params
        self.solve_c_batch = solve_c_batch
        self.audit = audit
        self._sla_source = sla_source
        self.shed_policy = shed_policy
        self.scheduler = make_scheduler(
            self.policy, params, worst_r_dev=worst_r_dev,
            worst_rtt=worst_rtt, batch_size=self.batch_size,
            batch_model=self.batch_model, solve_c_batch=solve_c_batch)
        self.admission: Optional[BatchingAdmission] = (
            self.scheduler.admission()
            if self.scheduler.supports_batching and self.batch_size > 1
            else None)
        # batch-2 slowdown measurement (single source of truth with the
        # scheduler/admission pair)
        self._c_batch_2 = getattr(self.scheduler, "c_batch_measured",
                                  params.c_batch)
        self.route_policy: Optional[RoutePolicy] = (
            RoutePolicy(capacity, params,
                        deadline_aware=dispatch == "edf")
            if capacity is not None else None)
        # wire stage (docs/transport.md): resolve the error budget NOW
        # (WirePolicy.error_budget=None defers to JobSpec.error_budget)
        # so config_json() serializes a concrete budget and from_config
        # rebuilds the exact same candidate set.  An empty candidate set
        # — wire=None, or a budget no non-fp32 format fits under — makes
        # the whole stage a no-op and planning bit-identical to the
        # pre-wire pipeline.
        if isinstance(wire, dict):
            wire = WirePolicy.from_json(wire)
        if wire is not None and wire.error_budget is None:
            wire = dataclasses.replace(wire, error_budget=job.error_budget)
        self.wire = wire
        self._wire_candidates: Tuple[WireFormat, ...] = tuple(
            WIRE_FORMATS[n] for n in wire.formats
            if n != "fp32" and WIRE_FORMATS[n].error <= wire.error_budget
        ) if wire is not None else ()
        # plan() embeds the config in every decision; it only changes
        # on set_t_lim, so cache the dict (treated as read-only by
        # decisions; to_json() deep-copies it for the wire)
        self._config_cache: Optional[Dict[str, Any]] = None
        #: monotone counter of decision-relevant config mutations; the
        #: PlanCache validates entries against it, so set_t_lim /
        #: set_capacity / set_shed_policy can never serve stale plans
        self.config_epoch = 0
        self.plan_calls = 0
        # cache=True builds a fresh PlanCache; pass a PlanCache to size/
        # tune it, or False/None to disable.  The cache engages only in
        # hot-loop (audit=False) mode: audited decisions embed per-
        # request payloads and are never shared.
        if isinstance(cache, PlanCache):
            self.cache: Optional[PlanCache] = cache   # caller-provided
        elif cache:                       # any truthy flag (True, 1, a
            self.cache = PlanCache()      # numpy bool from a config...)
        else:
            self.cache = None
        self._cb_cache: Dict[int, float] = {}

    # -- construction helpers ----------------------------------------------
    @classmethod
    def from_params(cls, params: CostParams, **kw) -> "Planner":
        return cls(params, **kw)

    @classmethod
    def from_config(cls, d: Mapping[str, Any]) -> "Planner":
        """Rebuild a planner from ``config_json()`` output (replay)."""
        return cls(
            CostParams(**d["params"]),
            capacity=CloudCapacity.from_json(d["capacity"])
            if d.get("capacity") else None,
            policy=d["policy"], batch_size=d["batch_size"],
            batch_model=BatchModel(**d["batch_model"])
            if d.get("batch_model") else None,
            worst_r_dev=d.get("worst_r_dev", SLOWEST_DEVICE),
            worst_rtt=d.get("worst_rtt", 0.3),
            dispatch=d.get("dispatch", "fifo"),
            solve_c_batch=d.get("solve_c_batch", 1.0),
            sla_source=d.get("sla_source", "fixed"),
            shed_policy=ShedPolicy(**d["shed_policy"])
            if d.get("shed_policy") else None,
            wire=WirePolicy.from_json(d["wire"])
            if d.get("wire") else None)

    def config_json(self) -> Dict[str, Any]:
        """Everything needed to rebuild this planner deterministically
        (embedded in every PlanDecision for replay; cached — the config
        only changes on set_t_lim)."""
        if self._config_cache is not None:
            return self._config_cache
        self._config_cache = {
            "params": dataclasses.asdict(self.p),
            "policy": self.policy,
            "batch_size": self.batch_size,
            "batch_model": dataclasses.asdict(self.batch_model)
            if self.batch_model else None,
            "worst_r_dev": self.worst_r_dev,
            "worst_rtt": self.worst_rtt,
            "dispatch": self.dispatch,
            "solve_c_batch": self.solve_c_batch,
            "capacity": self.capacity.to_json() if self.capacity else None,
            "sla_source": self._sla_source,
            "shed_policy": dataclasses.asdict(self.shed_policy)
            if self.shed_policy else None,
            "wire": self.wire.to_json() if self.wire else None,
        }
        return self._config_cache

    # -- SLA adaptation hook (§7) ------------------------------------------
    def set_t_lim(self, t_lim: float, source: str = "adaptive") -> None:
        """Apply a new SLA target to FUTURE decisions: the per-request
        solver and the batching admission both see it (in-flight
        deadlines are contracts and are not touched — core.sla)."""
        if t_lim == self.p.t_lim:
            return
        self.p = dataclasses.replace(self.p, t_lim=t_lim)
        self.scheduler.p = self.p
        if self.admission is not None:
            self.admission.p = self.p
        self._sla_source = source
        self._config_cache = None
        self.config_epoch += 1            # invalidates every cached plan

    def set_capacity(self, capacity: Optional[CloudCapacity]) -> None:
        """Swap the capacity model (advisory routing + dispatch-time
        route policy) for FUTURE decisions; invalidates cached plans."""
        self.capacity = capacity
        self.route_policy = (
            RoutePolicy(capacity, self.p,
                        deadline_aware=self.dispatch == "edf")
            if capacity is not None else None)
        self._config_cache = None
        self.config_epoch += 1

    def set_shed_policy(self, shed_policy: Optional[ShedPolicy]) -> None:
        """Swap the load-shedding pressure valve for FUTURE decisions;
        invalidates cached plans."""
        self.shed_policy = shed_policy
        self._config_cache = None
        self.config_epoch += 1

    # -- batching constants -------------------------------------------------
    def c_batch_of(self, batch_size: int) -> float:
        """Slowdown of a batch-b cloud launch: the fitted BatchModel when
        calibrated timings were given, else the §4.4 linear
        extrapolation from the pinned batch-2 measurement.  Memoized:
        the constants behind it never mutate, and the fleet simulator
        asks per dispatched batch."""
        cb = self._cb_cache.get(batch_size)
        if cb is None:
            if self.batch_model is not None:
                cb = self.batch_model.c_batch(batch_size)
            else:
                cb = c_batch_at(self._c_batch_2, batch_size)
            self._cb_cache[batch_size] = cb
        return cb

    # -- the pipeline -------------------------------------------------------
    def plan(self, request: PlanRequest) -> PlanDecision:
        """Run the policy pipeline for one request.

        Audit mode runs the full inline pipeline (trace + replay
        payloads, advisory routing).  Hot-loop (audit=False) mode runs
        the same value pipeline through the PlanCache: repeat device
        profiles skip the split/quantize/admission/shed re-derivation
        and only the hint-dependent verdicts re-run.
        """
        if not self.audit:
            return self.plan_profile(request.profile(),
                                     request.queue_delay_hint,
                                     request.utilization_hint)
        return self._plan_audited(request)

    # -- hot path: memoized profile solve + hint-dependent assembly ---------
    def plan_profile(self, prof: DeviceProfile,
                     queue_delay_hint: float = 0.0,
                     utilization_hint: float = 0.0) -> PlanDecision:
        """Plan for a bare DeviceProfile (the fleet simulator's per-
        arrival entry: no PlanRequest wrapper to build or unpack).
        Only valid in hot-loop mode — audited planners need the request
        payload for their replay contract."""
        self.plan_calls += 1
        cache = self.cache
        if cache is not None and cache.quanta is None:
            # inlined PlanCache.key_for exact branch (hot path; the
            # tuples must stay in lockstep — pinned by
            # test_plan_cache.test_cache_quanta_buckets_continuous_fields)
            key = (prof.r_dev, prof.rtt, prof.bandwidth, prof.k_decode,
                   prof.has_accelerator)
        elif cache is not None:
            key = cache.key_for(prof)
        else:
            entry = self._solve_profile(prof)
            return self._finish(prof, queue_delay_hint, utilization_hint,
                                entry)
        entry = cache._entries.get(key)
        if entry is not None and entry.epoch == self.config_epoch:
            cache.hits += 1
            if (queue_delay_hint == entry.last_qhint
                    and utilization_hint == entry.last_uhint
                    and prof.device_id == entry.last_device_id):
                return entry.last_decision
            # hints above the admission slack all yield the SAME denial
            # (max_wait=0; no other stage reads the hint), so share one
            # decision object across them — exactness argument in the
            # _PlanEntry docstring
            if (queue_delay_hint >= entry.deny_slack
                    and prof.device_id == entry.asg.device_id
                    and (self.shed_policy is None
                         or not self.shed_policy.pressured_hints(
                             queue_delay_hint, utilization_hint,
                             self.p.t_lim))):
                decision = entry.deny_decision
                if decision is None:
                    decision = self._finish(prof, queue_delay_hint,
                                            utilization_hint, entry)
                    entry.deny_decision = decision
                return decision
        else:
            cache.misses += 1
            entry = self._solve_profile(prof)
            cache.store(key, entry)
        decision = self._finish(prof, queue_delay_hint, utilization_hint,
                                entry)
        entry.last_qhint = queue_delay_hint
        entry.last_uhint = utilization_hint
        entry.last_device_id = prof.device_id
        entry.last_decision = decision
        return decision

    def _wire_select(self, prof: DeviceProfile):
        """Stage 2.5 — wire-format selection (docs/transport.md).

        Solves the split once per candidate format with the format's
        transfer-time delta (``WireFormat.t_wire``: bytes saved at the
        link bandwidth minus the codec charge) folded into the network
        term, then keeps the best by ``(feasible, n_final, latency,
        error)`` — feasibility first, then FEWEST cloud iterations (the
        paper's minimize-cloud-compute objective: a cheaper wire means
        the device can keep more steps inside the same SLA), latency,
        and only then accuracy spent.  fp32 wins every tie, so an empty
        candidate set or no strict improvement leaves the pre-wire plan
        bit-identical.

        Returns ``(assignment, wire_name, effective_profile)`` — the
        effective profile carries the wire-adjusted rtt so downstream
        stages (batching admission) price the same link the solve did.
        A candidate whose solve lands at ``n_final <= 0`` is discarded:
        with no cloud leg there is no boundary transfer, so its modeled
        discount is fictitious.
        """
        base = self.scheduler.assign_one(prof)
        if not self._wire_candidates or base.n_final <= 0:
            return base, "fp32", prof
        best_key = (not base.feasible, base.n_final, base.latency, 0.0)
        best = (base, "fp32", prof)
        payload = self.wire.payload_bytes
        for fmt in self._wire_candidates:
            tw = fmt.t_wire(payload, prof.bandwidth)
            prof_f = dataclasses.replace(prof, rtt=prof.rtt + tw)
            af = self.scheduler.assign_one(prof_f)
            if af.n_final <= 0:
                continue
            key = (not af.feasible, af.n_final, af.latency, fmt.error)
            if key < best_key:
                best_key = key
                best = (af, fmt.name, prof_f)
        return best

    def _solve_profile(self, prof: DeviceProfile) -> _PlanEntry:
        """Stages whose outputs depend only on the device profile and
        the planner config: split solve + quantization, wire-format
        selection, solo GPU time, the §4.4 admission latencies, and the
        pure-local latency the shedding stage compares against."""
        p = self.p
        a, wire, eff_prof = self._wire_select(prof)
        gpu_time = cloud_gpu_time(a.n_final, p) if a.n_final > 0 else 0.0
        has_admission = self.admission is not None and a.n_final > 0
        if has_admission:
            solo, batched = self.admission.latencies(a.n_final, prof.r_dev,
                                                     eff_prof.rtt)
            deny_slack = ((p.t_lim - batched) if self.admission.saves_time
                          else -math.inf)
        else:
            solo = batched = a.latency
            deny_slack = -math.inf       # decision is hint-independent
        local_lat = (e2e_latency(0, prof.r_dev, p, prof.rtt, c_batch=1.0)
                     if self.shed_policy is not None else 0.0)
        return _PlanEntry(self.config_epoch, a, gpu_time, has_admission,
                          solo, batched, local_lat, deny_slack, wire)

    # -- cohort path: one vectorized solve for many profiles ----------------
    def plan_cohort(self, profiles, queue_delay_hint: float = 0.0,
                    utilization_hint: float = 0.0) -> List[PlanDecision]:
        """Plan a whole cohort of device profiles at once (the v2
        simulation core's entry point).

        The profile-dependent stages are solved in ONE numpy pass
        (``cost_model.solve_n_cloud_batch``) and the resulting
        ``_PlanEntry``s — bit-identical to ``_solve_profile``'s, see the
        batch/scalar equality property test — are installed in the
        ``PlanCache``.  Decisions are then assembled per profile through
        the exact same ``plan_profile`` / ``BatchingAdmission.decide_from``
        verdict path the scalar planner uses, so traces recorded from a
        cohort-planned run still pass ``replay.verify_decisions``.

        Only valid in hot-loop mode (``audit=False``), like
        ``plan_profile``.  Counter note: cohort pre-solves are counted as
        cache misses and the per-profile assemblies as hits.
        """
        if self.audit:
            raise ValueError("plan_cohort requires hot-loop mode "
                             "(Planner(audit=False))")
        profiles = list(profiles)
        if not profiles:
            return []
        cache = self.cache
        if cache is None:
            entries = self._solve_cohort(profiles)
            self.plan_calls += len(profiles)
            return [self._finish(pr, queue_delay_hint, utilization_hint, e)
                    for pr, e in zip(profiles, entries)]
        epoch = self.config_epoch
        exact = cache.quanta is None
        todo: List[DeviceProfile] = []
        keys: List[tuple] = []
        seen = set()
        entries_map = cache._entries
        for pr in profiles:
            key = ((pr.r_dev, pr.rtt, pr.bandwidth, pr.k_decode,
                    pr.has_accelerator) if exact else cache.key_for(pr))
            if key in seen:
                continue
            e = entries_map.get(key)
            if e is not None and e.epoch == epoch:
                continue
            seen.add(key)
            todo.append(pr)
            keys.append(key)
        if todo:
            cache.misses += len(todo)
            for key, e in zip(keys, self._solve_cohort(todo)):
                cache.store(key, e)
        return [self.plan_profile(pr, queue_delay_hint, utilization_hint)
                for pr in profiles]

    def _solve_cohort(self, profiles: List[DeviceProfile]) -> List[_PlanEntry]:
        """Vectorized ``_solve_profile``: same values, one numpy pass.

        Only the concrete Table-4 scheduler types have a closed vector
        form; unknown scheduler subclasses fall back to the scalar solve
        (still one entry per profile, just not batched).
        """
        sched = self.scheduler
        cls = type(sched)
        p = self.p
        if self._wire_candidates:
            # wire selection re-solves per candidate format with a
            # format- and bandwidth-dependent rtt shift — no closed
            # vector form yet, so wire-active configs take the scalar
            # path (one entry per profile, values identical)
            return [self._solve_profile(pr) for pr in profiles]
        k = len(profiles)
        r_dev = np.fromiter((pr.r_dev for pr in profiles), np.float64, k)
        rtt = np.fromiter((pr.rtt for pr in profiles), np.float64, k)
        if cls is VariableIterationScheduler or \
                cls is IntelligentBatchingScheduler:
            n_exact = solve_n_cloud_batch(r_dev, rtt, p,
                                          c_batch=sched.solve_c_batch)
            n_final = quantize_step_batch(n_exact, p.n_step, p.n_total)
        elif cls is ConstantIterationScheduler:
            n_exact = np.full(k, float(sched.n_const))
            n_final = np.full(k, sched.n_const, np.int64)
        elif cls is AllCloudScheduler:
            n_exact = np.full(k, float(p.n_total))
            n_final = np.full(k, p.n_total, np.int64)
        else:
            return [self._solve_profile(pr) for pr in profiles]
        nf = n_final.astype(np.float64)
        # identical expression (and operation order) to _mk_assignment /
        # BatchingAdmission.latencies at c_batch=1.0, so `lat` doubles as
        # the admission's solo latency bit-for-bit
        lat = e2e_latency_batch(nf, r_dev, p, rtt, c_batch=1.0)
        feas = lat <= p.t_lim + 1e-9
        gpu = nf * 1.0 / p.r_cloud        # cloud_gpu_time, vectorized
        adm = self.admission
        if adm is not None:
            batched_lat = e2e_latency_batch(nf, r_dev, p, rtt,
                                            c_batch=adm.c_batch)
            saves_time = adm.saves_time
        shed = self.shed_policy is not None
        if shed:
            local = e2e_latency_batch(0.0, r_dev, p, rtt, c_batch=1.0)
        epoch = self.config_epoch
        t_lim = p.t_lim
        entries = []
        for i, pr in enumerate(profiles):
            nfi = int(n_final[i])
            lat_i = float(lat[i])
            a = Assignment(
                device_id=pr.device_id, r_dev=pr.r_dev, t_network=pr.rtt,
                n_exact=float(n_exact[i]), n_final=nfi, latency=lat_i,
                feasible=bool(feas[i]))
            if adm is not None and nfi > 0:
                b_i = float(batched_lat[i])
                entries.append(_PlanEntry(
                    epoch, a, float(gpu[i]), True, lat_i, b_i,
                    float(local[i]) if shed else 0.0,
                    (t_lim - b_i) if saves_time else -math.inf))
            else:
                entries.append(_PlanEntry(
                    epoch, a, float(gpu[i]) if nfi > 0 else 0.0, False,
                    lat_i, lat_i,
                    float(local[i]) if shed else 0.0, -math.inf))
        return entries

    def _finish(self, prof: DeviceProfile, queue_delay_hint: float,
                utilization_hint: float,
                entry: _PlanEntry) -> PlanDecision:
        """Hint-dependent assembly: §4.4 admission verdict + load
        shedding + decision construction.  Value-identical to the
        audited pipeline (pinned by test_non_audit_plan_matches_audit_
        values and the cached==uncached property tests)."""
        p = self.p
        a = entry.asg
        if a.device_id != prof.device_id:
            # same (r_dev, rtt, ...) key from a different device: the
            # decision values are identical, but the Assignment names
            # the requester
            a = dataclasses.replace(a, device_id=prof.device_id)
        gpu_time = entry.gpu_time

        if entry.has_admission:
            dec = self.admission.decide_from(a.n_final, entry.solo,
                                             entry.batched,
                                             queue_delay_hint)
            admit, max_wait = dec.admit, dec.max_wait
            batch_lat, solo_lat = dec.batched_latency, dec.solo_latency
            reason = dec.reason
        else:
            admit, max_wait = False, 0.0
            batch_lat, solo_lat = a.latency, a.latency
            reason = (f"policy {self.policy!r} does not batch"
                      if self.admission is None
                      else "local-only request; nothing to batch")

        action, shed_reason = "admit", ""
        wire = entry.wire
        gpu_class: Optional[str] = None
        cloud_rate = p.r_cloud
        if self.shed_policy is not None and a.n_final > 0 \
                and self.shed_policy.pressured_hints(
                    queue_delay_hint, utilization_hint, p.t_lim):
            local_lat = entry.local_lat
            queued_lat = a.latency + queue_delay_hint
            ceil = self.shed_policy.degrade_ceil * p.t_lim
            hint = (f"queue_hint={queue_delay_hint:.3g}s, "
                    f"util_hint={utilization_hint:.2f}")
            if queued_lat <= p.t_lim + 1e-9:
                shed_reason = (f"pressure ({hint}) but the queued cloud "
                               f"plan still fits: {queued_lat:.4g} <= "
                               f"{p.t_lim:.4g}")
            elif local_lat <= ceil + 1e-9:
                action = "degrade-to-local"
                shed_reason = (f"pressure ({hint}); queued cloud plan "
                               f"misses t_lim ({queued_lat:.4g}s) but the "
                               f"device finishes in {local_lat:.4g}s <= "
                               f"{ceil:.4g}s — §7 graceful degradation")
                a = dataclasses.replace(
                    a, n_final=0, latency=local_lat,
                    feasible=local_lat <= p.t_lim + 1e-9,
                    batched=False, batch_factor=1.0,
                    t_network=prof.rtt)
                gpu_time = 0.0
                admit, max_wait = False, 0.0
                reason = "shed: degraded to local; nothing to batch"
                wire = "fp32"            # nothing ships; no codec to run
            else:
                action = "reject"
                shed_reason = (f"pressure ({hint}) and no winnable plan: "
                               f"queued cloud {queued_lat:.4g}s misses "
                               f"t_lim and local {local_lat:.4g}s > "
                               f"degrade ceiling {ceil:.4g}s")

        return PlanDecision(
            request={}, planner={},
            n_exact=a.n_exact, n_final=a.n_final, latency=a.latency,
            feasible=a.feasible, gpu_time=gpu_time, gpu_class=gpu_class,
            cloud_rate=cloud_rate, batch_admit=admit,
            batch_max_wait=max_wait, batch_latency=batch_lat,
            batch_solo_latency=solo_lat, batch_reason=reason,
            t_lim=p.t_lim, trace=[], action=action,
            shed_reason=shed_reason, wire=wire, _assignment=a)

    def _plan_audited(self, request: PlanRequest) -> PlanDecision:
        """The fully traced pipeline (audit=True)."""
        self.plan_calls += 1
        prof = request.profile()
        p = self.p
        audit = True
        trace: List[Dict[str, Any]] = []

        # 1+2. split solve + quantize (the Table-4 per-request policy),
        # with the wire-format stage (2.5) folded into the solve: each
        # candidate encoding shifts the network term and the best
        # (feasibility, n_final, latency, error) plan wins — fp32 on
        # ties, so a budget of 0 reproduces the pre-wire pipeline.
        a, wire, eff_prof = self._wire_select(prof)
        if audit:
            trace.append(_t("n_exact", a.n_exact,
                            f"split:{self.scheduler.name}",
                            f"solve over r_dev={prof.r_dev:.4g}, "
                            f"rtt={prof.rtt:.4g}, t_lim={p.t_lim:.4g}"))
            trace.append(_t("n_final", a.n_final,
                            f"quantize:n_step={p.n_step}",
                            "round up to the step grid "
                            "(batchable groups)"))
            trace.append(_t("latency", a.latency, "model:e2e_latency",
                            f"solo prediction at reference rate "
                            f"r_cloud={p.r_cloud:.4g}"))
            trace.append(_t("feasible", a.feasible, "model:e2e_latency",
                            f"latency <= t_lim={p.t_lim:.4g}"))
            if self._wire_candidates:
                fmt = WIRE_FORMATS[wire]
                trace.append(_t(
                    "wire", wire, "wire:error-budget",
                    f"{len(self._wire_candidates)} candidate(s) within "
                    f"budget {self.wire.error_budget:.4g}; picked "
                    f"error={fmt.error:.4g}, t_wire="
                    f"{fmt.t_wire(self.wire.payload_bytes, prof.bandwidth):.4g}s "
                    f"at bw={prof.bandwidth:.4g} B/s"))
            else:
                trace.append(_t("wire", wire, "wire:off",
                                "no wire policy or zero error budget: "
                                "boundary ships dense fp32"))

        # 3. class routing (advisory: queue-blind cheapest feasible —
        # skipped in non-audit mode, where routing happens at dispatch)
        gpu_class: Optional[str] = None
        cloud_rate = p.r_cloud
        if audit and a.n_final > 0 and self.capacity is not None:
            cls = cheapest_feasible_class(a.n_final, prof.r_dev, prof.rtt,
                                          p, self.capacity)
            gpu_class, cloud_rate = cls.name, cls.r_cloud
            trace.append(_t("gpu_class", gpu_class,
                            "route:cheapest_feasible_class",
                            "advisory; dispatch-time routing adds live "
                            "queue state (route_policy)"))
        elif audit:
            trace.append(_t("gpu_class", gpu_class,
                            "route:none" if a.n_final <= 0
                            else "route:reference",
                            "local-only request" if a.n_final <= 0
                            else "no capacity model attached"))
        gpu_time = cloud_gpu_time(a.n_final, p) if a.n_final > 0 else 0.0
        if audit:
            trace.append(_t("gpu_time", gpu_time, "model:cloud_gpu_time",
                            "solo GPU-seconds at the reference rate"))

        # 4. batching admission (§4.4, online form; a local-only request
        # has nothing to batch — only the audit trace wants the verdict)
        if self.admission is not None and (a.n_final > 0 or audit):
            dec = self.admission.decide(
                a.n_final, prof.r_dev, eff_prof.rtt,
                queue_delay_hint=request.queue_delay_hint)
            admit, max_wait = dec.admit, dec.max_wait
            batch_lat, solo_lat = dec.batched_latency, dec.solo_latency
            reason = dec.reason
            if audit:
                trace.append(_t("batch_admit", admit,
                                "batching:§4.4-online", reason))
        else:
            admit, max_wait = False, 0.0
            batch_lat, solo_lat = a.latency, a.latency
            reason = (f"policy {self.policy!r} does not batch"
                      if self.admission is None
                      else "local-only request; nothing to batch")
            if audit:
                trace.append(_t("batch_admit", False, "batching:none",
                                reason))

        # 5. admission-level load shedding: under queue/utilization
        # pressure, cloud-optional requests degrade to pure-local
        # service (saving the cloud work entirely) and only requests
        # with NO winnable plan are rejected.  Runs in non-audit mode
        # too — it is value-bearing, not advisory.
        action, shed_reason = "admit", ""
        if self.shed_policy is not None and a.n_final > 0 \
                and self.shed_policy.pressured(request, p.t_lim):
            local_lat = e2e_latency(0, prof.r_dev, p, prof.rtt,
                                    c_batch=1.0)
            queued_lat = a.latency + request.queue_delay_hint
            ceil = self.shed_policy.degrade_ceil * p.t_lim
            hint = (f"queue_hint={request.queue_delay_hint:.3g}s, "
                    f"util_hint={request.utilization_hint:.2f}")
            if queued_lat <= p.t_lim + 1e-9:
                shed_reason = (f"pressure ({hint}) but the queued cloud "
                               f"plan still fits: {queued_lat:.4g} <= "
                               f"{p.t_lim:.4g}")
            elif local_lat <= ceil + 1e-9:
                action = "degrade-to-local"
                shed_reason = (f"pressure ({hint}); queued cloud plan "
                               f"misses t_lim ({queued_lat:.4g}s) but the "
                               f"device finishes in {local_lat:.4g}s <= "
                               f"{ceil:.4g}s — §7 graceful degradation")
                a = dataclasses.replace(
                    a, n_final=0, latency=local_lat,
                    feasible=local_lat <= p.t_lim + 1e-9,
                    batched=False, batch_factor=1.0,
                    t_network=prof.rtt)
                gpu_time, gpu_class, cloud_rate = 0.0, None, p.r_cloud
                admit, max_wait = False, 0.0
                reason = "shed: degraded to local; nothing to batch"
                wire = "fp32"            # nothing ships; no codec to run
            else:
                action = "reject"
                shed_reason = (f"pressure ({hint}) and no winnable plan: "
                               f"queued cloud {queued_lat:.4g}s misses "
                               f"t_lim and local {local_lat:.4g}s > "
                               f"degrade ceiling {ceil:.4g}s")
        if audit:
            trace.append(_t("action", action,
                            "shed:pressure-valve" if self.shed_policy
                            else "shed:none", shed_reason))

        # 6. SLA adaptation: record the target this decision ran under
        if audit:
            trace.append(_t("t_lim", p.t_lim, f"sla:{self._sla_source}",
                            "set_t_lim() is the §7 adaptive controller "
                            "hook"))

        return PlanDecision(
            request=request.to_json() if audit else {},
            planner=self.config_json() if audit else {},
            n_exact=a.n_exact, n_final=a.n_final, latency=a.latency,
            feasible=a.feasible, gpu_time=gpu_time, gpu_class=gpu_class,
            cloud_rate=cloud_rate, batch_admit=admit,
            batch_max_wait=max_wait, batch_latency=batch_lat,
            batch_solo_latency=solo_lat, batch_reason=reason,
            t_lim=p.t_lim, trace=trace, action=action,
            shed_reason=shed_reason, wire=wire, _assignment=a)

    # -- replan-on-preemption ------------------------------------------------
    def replan_preempted(self, request: PlanRequest, n_done: int,
                         time_left: float) -> PlanDecision:
        """Re-plan a request whose cloud job was killed by a spot
        reclaim, after ``n_done`` of its cloud iterations completed and
        with ``time_left`` seconds of its original e2e deadline
        remaining.

        Elapsed-time credit + tightened deadline: the effective job is
        the original one minus the iterations already banked
        (``n_total' = n_total - n_done``) under the remaining budget
        (``t_lim' = time_left``), so the SAME pipeline solves the
        remaining split — the decision's ``n_final`` is the ADDITIONAL
        cloud iterations to run.  ``n_final == 0`` means the device can
        finish the remainder locally within the budget; a non-positive
        ``time_left`` degenerates to best-effort all-remaining-on-cloud
        (``feasible=False``), mirroring ``solve_n_cloud`` saturating.

        The decision embeds the EFFECTIVE planner config, so audited
        replans stay deterministically replayable.  Shedding is not
        applied here: an in-flight request is never rejected after
        admission — re-admission only chooses where the remaining work
        runs.
        """
        return self._replan_credit(request, n_done, time_left,
                                   sla_source="replan:preemption",
                                   shed_policy=None)

    # -- replan-on-network-degradation ---------------------------------------
    def replan_degraded(self, request: PlanRequest, n_done: int,
                        time_left: float) -> PlanDecision:
        """Re-plan a request whose session link degraded mid-flight
        (``serving/mobility.py``): same elapsed-time-credit machinery
        as ``replan_preempted`` — preemption and degradation are both
        "replan with credit" — but the degraded ``request.device``
        carries the LIVE link, and this planner's shed policy stays
        active: a disconnected or hopeless link flows through the
        admit / degrade-to-local / reject valve instead of shipping a
        split that can no longer land.  Pass the current
        ``utilization_hint`` on ``request`` so the pressure hints match
        what an arrival would see.
        """
        return self._replan_credit(request, n_done, time_left,
                                   sla_source="replan:net-shift",
                                   shed_policy=self.shed_policy)

    def _replan_credit(self, request: PlanRequest, n_done: int,
                       time_left: float, sla_source: str,
                       shed_policy: Optional[ShedPolicy]) -> PlanDecision:
        """Shared replan-with-elapsed-credit core (see callers)."""
        if n_done < 0:
            raise ValueError(f"n_done must be >= 0, got {n_done}")
        p_eff = dataclasses.replace(
            self.p, n_total=max(0, self.p.n_total - n_done),
            t_lim=time_left)
        replanner = Planner(
            p_eff, capacity=self.capacity, policy=self.policy,
            batch_size=self.batch_size, batch_model=self.batch_model,
            worst_r_dev=self.worst_r_dev, worst_rtt=self.worst_rtt,
            dispatch=self.dispatch, solve_c_batch=self.solve_c_batch,
            audit=self.audit, sla_source=sla_source,
            shed_policy=shed_policy, wire=self.wire,
            cache=False)      # one-shot planner: nothing to re-hit
        return replanner.plan(request)


# --------------------------------------------------------------------------
# Facade conveniences
# --------------------------------------------------------------------------
def plan(device: DeviceProfile, params: CostParams,
         policy: str = "variable+batching",
         capacity: Optional[CloudCapacity] = None,
         network: Optional[NetworkProfile] = None, **kw) -> PlanDecision:
    """One-shot: build a Planner and plan a single request."""
    planner = Planner(params, policy=policy, capacity=capacity, **kw)
    return planner.plan(PlanRequest(device=device, network=network))


def replay(decision) -> PlanDecision:
    """Replay a serialized decision (dict, JSON string, or PlanDecision)
    deterministically from its embedded planner config + request."""
    if isinstance(decision, str):
        decision = json.loads(decision)
    if isinstance(decision, Mapping):
        decision = PlanDecision.from_json(decision)
    return decision.replay()
