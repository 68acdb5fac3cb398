"""Event-driven fleet serving simulator: the paper's scheduler (§4.3),
batching (§4.4) and GPU allocation (§4.5) with a TIME axis — over a
heterogeneous cloud.

The static ``serving.simulator`` assigns a fixed fleet in one shot; this
module models the production system the paper argues for: requests
arrive continuously (Poisson / bursty / diurnal), each arrival flows
through the unified planner (``core.planner.Planner.plan``: split solve
-> quantize -> class routing -> §4.4 batching admission -> SLA), so one
``PlanRequest``/``PlanDecision`` round-trip yields the ``n_final``
group AND the window-admission verdict.  Admitted requests wait in
per-group batching windows, batches execute on a modeled GPU pool, and
an autoscaler driven by the §4.5 allocator grows the pool on a sliding
demand horizon and releases idle GPUs back to production jobs.

Cloud capacity is a ``core.capacity.CloudCapacity`` — one or more GPU
classes (generation + spot slices), each backed by its own ``GpuPool``
behind a single ``HeterogeneousDispatcher``:

* routing: each cloud job goes to the CHEAPEST class whose rate still
  meets its deadline (``dispatch="edf"``), or to the first class with a
  free GPU (``dispatch="fifo"``, the deadline-blind baseline);
* queueing: per-class queues pop earliest-deadline-first under "edf"
  (deadline = arrival + t_lim − device_tail − rtt, read from the
  ``core.sla.DeadlineTracker`` clocks) and FIFO under "fifo";
* autoscaling: the §4.5 re-plan sizes aggregate supply at the capacity's
  reference rate, then meets it per class — spot scales first, spot
  releases first (``allocate_gpus_heterogeneous``);
* adaptive SLA (``adaptive_sla=True``): the §7 controller watches
  observed pool utilization each re-plan and relaxes / tightens
  ``t_lim`` for FUTURE arrivals, so bursty load sheds latency instead of
  violating deadlines.

With the default homogeneous single-class capacity and FIFO dispatch the
simulator is bit-identical to the pre-capacity refactor: the golden
trace and the Table-4 steady-state convergence are the regression
anchors.

Spot preemption (``preempt_rate`` / ``preempt_trace``, see
docs/preemption.md): preemptible classes can LOSE GPUs mid-job — a
Poisson reclaim process (or a scripted trace) takes idle spot GPUs
first, then kills running jobs.  Killed jobs' members re-enter through
``planner.replan_preempted`` carrying elapsed-time credit (iterations
already banked) under their tightened remaining deadline
(``preempt_requeue="replan"``), or are resubmitted whole with no credit
(``"naive"``, the baseline).  The §4.5 re-plan sees preemption too:
spot supply is discounted by ``capacity.preemption_discount`` so the
autoscaler provisions preemption-aware headroom.  With the default
``preempt_rate=0`` every path is bit-identical to the no-preemption
simulator (the golden-trace anchor).

Admission-level load shedding (``shedding=True``): the planner pipeline
gains a pressure valve — under queue/utilization pressure,
cloud-optional arrivals degrade to pure-local service and only requests
with no winnable plan are rejected (``PlanDecision.action``).

Event kinds (a single heapq drives everything):

  ARRIVAL      next request from the arrival process
  WINDOW       a batching window reached its flush deadline
  JOB_DONE     a GPU finished a (possibly batched) cloud job
  CAPACITY     provisioned GPUs came online (after provision_delay_s)
  AUTOSCALE    periodic §4.5 re-plan
  COMPLETE     device finished its local iterations + decode
  METRICS      periodic time-series snapshot
  PREEMPT      spot reclaim: a preemptible pool loses GPUs
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.capacity import (
    CloudCapacity,
    GpuClass,
    preemption_discount,
    reference_params,
)
from repro_torch.core.cost_model import (
    BatchModel,
    CostParams,
    e2e_latency,
)
from repro_torch.core.planner import (
    DISPATCH_MODES,
    PlanRequest,
    Planner,
    PoolSnapshot,
    RoutePolicy,
    ShedPolicy,
)
from repro_torch.core.scheduler import (
    Assignment,
    ScheduleSummary,
    allocate_gpus_heterogeneous,
    plan_capacity_targets,
)
from repro_torch.core.sla import AdaptiveSLAController, DeadlineTracker, SLAPolicy
from repro_torch.core.telemetry import (
    DeviceProfile,
    StreamingLatencyStats,
    bursty_arrival_blocks,
    bursty_arrivals,
    diurnal_arrival_blocks,
    diurnal_arrivals,
    fleet_sampler,
    latency_percentile,
    poisson_arrival_blocks,
    poisson_arrivals,
)
from repro_torch.core.transport import WirePolicy
from repro_torch.serving.event_wheel import EventWheel
from repro_torch.serving.mobility import MobilityConfig, MobilityModel
from repro_torch.serving.simulator import CALIBRATED, table4_fleet

# event kinds, in tie-break priority order at equal timestamps: capacity
# comes online before jobs are dispatched, arrivals before window
# flushes.  PREEMPT was appended after the original six so adding it
# could not reorder any pre-preemption event sequence; NET_SHIFT
# (serving.mobility) is appended after PREEMPT for the same reason —
# the golden-trace anchor never sees either.
(EVT_CAPACITY, EVT_JOB_DONE, EVT_ARRIVAL, EVT_WINDOW, EVT_AUTOSCALE,
 EVT_COMPLETE, EVT_METRICS, EVT_PREEMPT, EVT_NET_SHIFT) = range(9)
# DISPATCH_MODES is canonical in core.planner (imported above) so the
# planner and the dispatcher can never disagree on valid modes


# --------------------------------------------------------------------------
# Config / records
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SimConfig:
    policy: str = "variable+batching"
    params: CostParams = CALIBRATED
    # arrival process
    process: str = "poisson"            # "poisson" | "bursty" | "diurnal"
    rate: float = 20.0                  # mean requests/s
    duration: float = 120.0             # arrival horizon, seconds
    max_rate: Optional[float] = None    # poisson only: master rate (nesting)
    diurnal_period_s: float = 600.0
    seed: int = 0
    # device fleet feeding the stream
    fleet: Optional[List[DeviceProfile]] = None   # default: Table-4 fleet
    sampling: str = "cycle"             # "cycle" | "uniform"
    # batching windows (§4.4)
    batch_size: int = 2
    window_s: float = 1.0               # cap on any window's lifetime
    #: real multi-point batch timings ((batch_size, seconds), ...):
    #: calibrates the batching slope via fit_batch_model instead of the
    #: single pinned c_batch_at measurement (None keeps the legacy path)
    batch_timings: Optional[List[Tuple[int, float]]] = None
    # GPU pool + autoscaler (§4.5)
    #: heterogeneous capacity (core.capacity).  None builds a single
    #: homogeneous class from (params.r_cloud, gpus_init, min/max_gpus) —
    #: the pre-refactor pool, bit-identical behavior.
    capacity: Optional[CloudCapacity] = None
    #: "fifo" (legacy, the golden-trace anchor) or "edf": earliest-
    #: deadline-first queues + deadline-aware cheapest-class routing.
    dispatch: str = "fifo"
    gpus_init: int = 8
    min_gpus: int = 1
    max_gpus: int = 128
    provision_delay_s: float = 5.0
    autoscale: bool = True
    autoscale_interval_s: float = 5.0
    horizon_s: float = 30.0
    release_threshold: float = 0.5
    #: multiplier over the §4.5 work-conserving GPU floor.  allocate_gpus
    #: sizes for throughput only; running at its exact output means
    #: utilization ~1.0 and unbounded M/M/c queueing delay, so the
    #: autoscaler provisions this much slack to keep p99 under the SLA.
    headroom: float = 1.3
    # adaptive SLA (§7): relax t_lim under pressure instead of violating
    adaptive_sla: bool = False
    sla_floor: float = 1.0
    sla_ceil: float = 60.0
    sla_high_water: float = 0.85
    sla_low_water: float = 0.5
    # spot preemption (docs/preemption.md).  preempt_rate is the Poisson
    # reclaim hazard per provisioned preemptible GPU (reclaims/s/GPU);
    # preempt_trace schedules scripted reclaims [(t, class_name, k), ...]
    # on top.  0/None (default) disables preemption entirely — every
    # code path is bit-identical to the pre-preemption simulator.
    preempt_rate: float = 0.0
    preempt_trace: Optional[List[Tuple[float, str, int]]] = None
    #: what happens to a killed job's members: "replan" re-enters each
    #: through planner.replan_preempted (elapsed-time credit + tightened
    #: deadline), "naive" resubmits the whole job unchanged (full
    #: restart — the baseline the bench compares against)
    preempt_requeue: str = "replan"
    # admission-level load shedding (planner pipeline stage 5)
    shedding: bool = False
    shed_queue_high: float = 0.6
    shed_util_high: float = 0.95
    #: session network dynamics (serving.mobility, docs/mobility.md):
    #: per-session RTT/bandwidth drift, WiFi<->cellular handoff and
    #: disconnect/reconnect windows on a DEDICATED rng stream, surfaced
    #: as EVT_NET_SHIFT events.  When a session's link degrades past the
    #: configured thresholds while a job is in flight, the job re-enters
    #: the planner through Planner.replan_degraded (elapsed-time credit,
    #: shed valve active) — unless ``mobility.replan`` is False, the
    #: freeze-at-arrival baseline.  None (default) is bit-identical to
    #: the pre-mobility simulator (the golden-trace anchor).
    mobility: Optional["MobilityConfig"] = None
    #: boundary wire-format planning (core.transport.WirePolicy,
    #: docs/transport.md): when set, the planner's wire stage may trade
    #: accuracy budget for bytes on the cloud->device ship, and the
    #: SHIP time in the event dynamics carries the selected format's
    #: transfer delta (``Assignment.t_network`` = rtt + t_wire).  None
    #: (default) — and a WirePolicy whose resolved error budget admits
    #: no non-fp32 format — are bit-identical to the pre-wire simulator
    #: (the golden-trace anchor).
    wire: Optional["WirePolicy"] = None
    # telemetry
    metrics_interval_s: float = 5.0
    #: keep every CompletedRequest (the golden-trace default; run-level
    #: percentiles are exact).  False switches to the fixed-memory
    #: streaming estimator (telemetry.StreamingLatencyStats): counters +
    #: P² p50/p99, `completed` stays empty — the 10^6-arrival mode.
    #: Event dynamics are IDENTICAL either way; only stats storage
    #: changes.
    exact_stats: bool = True
    #: memoize Planner.plan across repeat device profiles (bit-identical
    #: decisions — see core.planner.PlanCache; False re-runs the full
    #: pipeline per arrival, the pre-cache behavior)
    plan_cache: bool = True
    #: write a structured JSONL decision trace here (serving.replay):
    #: one header record (planner config + sim metadata), then one
    #: record per plan / replan / dispatch / preempt.  The sink is
    #: write-only — event dynamics with trace_out set are bit-identical
    #: to the default None (the golden-trace anchor; pinned in
    #: tests/test_engine_replay.py).
    trace_out: Optional[str] = None
    #: simulation core (docs/sim_core_v2.md): "v1" (default) is the
    #: bit-identical golden-trace core; "v2" is the throughput core —
    #: block-vectorized arrivals, cohort-vectorized planning, bucketed
    #: time-wheel event queue.  v2 has its OWN rng consumption order and
    #: pinned baseline; aggregates match v1 within documented tolerance
    #: (tests/test_sim_core_v2.py), traces verify the same way.
    core: str = "v1"
    #: v2 only: event-wheel bucket width in seconds; None auto-sizes
    #: from the arrival rate (~a few events per bucket).  Setting this
    #: routes v2 through the wheel path (the chunked fast lane ignores
    #: bucket sizing, so it declares itself incompatible — see
    #: ``v2_fast``).
    v2_bucket_s: Optional[float] = None
    #: v2 only (exact_stats=False): number of StreamingLatencyStats
    #: shards filled round-robin and merged (P² merge) into the
    #: run-level stream at the end of the run.
    v2_stream_shards: int = 4
    #: v2 fast-lane policy: "auto" (default) runs the chunked fast lane
    #: when the config is eligible and falls back LOUDLY to the event
    #: wheel otherwise (FleetSimResult.fast_lane / fast_lane_blockers
    #: name the reasons); "require" raises if any option blocks the
    #: fast lane (nothing can be silently ignored); "off" always runs
    #: the wheel.
    v2_fast: str = "auto"
    #: v2 only (docs/sim_core_v2.md §Multiprocess sharding): worker
    #: processes for the cohort-sharded fast lane.  1 (default) is
    #: bit-identical to the single-process fast lane; > 1 partitions the
    #: fleet into ``shard_cohorts`` cohort shards run as parallel fast
    #: lanes with a barrier'd capacity exchange every ``shard_chunk_s``.
    #: Any fast-lane blocker (mobility, wire, preemption, ...) falls the
    #: run back to the single-process path — loudly, via
    #: ``fast_lane_blockers`` — because the shard workers ARE fast lanes.
    processes: int = 1
    #: number of cohort shards the fleet/arrival stream is partitioned
    #: into.  None auto-sizes to ``max(8, processes)``; the SIMULATION
    #: depends only on (seed, shard_cohorts), never on ``processes`` —
    #: each cohort draws rng substreams derived from the seed + cohort
    #: id, so results are identical for any worker count (the
    #: P-invariance anchor).  Setting this with processes=1 runs the
    #: sharded semantics in-process (no workers spawned).
    shard_cohorts: Optional[int] = None
    #: BSP barrier width in simulated seconds: at each multiple the
    #: workers exchange demand/queue/utilization aggregates and the
    #: coordinator re-plans §4.5 capacity once, fleet-wide.  None
    #: defaults to ``autoscale_interval_s`` (the §4.5 cadence) or
    #: ``metrics_interval_s`` when autoscale is off.
    shard_chunk_s: Optional[float] = None

    def validate(self) -> None:
        """Config cross-checks shared by both cores (raise early, not
        mid-run).  Core-specific checks (autoscale/preemption guards)
        stay in the simulator constructors."""
        if self.core not in ("v1", "v2"):
            raise ValueError(f"unknown core {self.core!r}; "
                             f"expected 'v1' or 'v2'")
        if self.v2_fast not in ("auto", "require", "off"):
            raise ValueError(f"unknown v2_fast {self.v2_fast!r}; "
                             f"expected 'auto', 'require' or 'off'")
        if self.processes < 1:
            raise ValueError(f"processes must be >= 1, got {self.processes}")
        if self.shard_cohorts is not None and self.shard_cohorts < 1:
            raise ValueError(f"shard_cohorts must be >= 1, "
                             f"got {self.shard_cohorts}")
        if self.shard_chunk_s is not None and self.shard_chunk_s <= 0:
            raise ValueError(f"shard_chunk_s must be > 0, "
                             f"got {self.shard_chunk_s}")
        if (self.processes > 1 or self.shard_cohorts is not None) \
                and self.core != "v2":
            raise ValueError("multiprocess sharding (processes > 1 / "
                             "shard_cohorts) requires core='v2'")
        if self.mobility is not None:
            self.mobility.validate()

    def resolved_shard_cohorts(self) -> int:
        """Cohort count the sharded path runs with.  The default couples
        to ``processes`` only beyond 8 workers, so results are invariant
        across processes in {1..8} without pinning shard_cohorts."""
        if self.shard_cohorts is not None:
            return self.shard_cohorts
        return max(8, self.processes)

    def resolved_shard_chunk_s(self) -> float:
        if self.shard_chunk_s is not None:
            return self.shard_chunk_s
        return (self.autoscale_interval_s if self.autoscale
                else self.metrics_interval_s)

    def build_capacity(self) -> CloudCapacity:
        if self.capacity is not None:
            return self.capacity
        return CloudCapacity.from_scalar(
            self.params.r_cloud, count=self.gpus_init,
            min_count=self.min_gpus, max_count=self.max_gpus)


@dataclasses.dataclass(slots=True)
class SimRequest:
    request_id: str
    arrival: float
    profile: DeviceProfile
    assignment: Assignment
    window_wait: float = 0.0
    queue_wait: float = 0.0
    cloud_service: float = 0.0          # wall time of its (batched) job
    batched: bool = False
    batch_slowdown: float = 1.0         # c_batch(b) its job actually ran at
    gpu_seconds: float = 0.0            # this request's share (all attempts)
    gpu_class: str = ""                 # class its cloud job ran on (last)
    gpu_cost: float = 0.0               # gpu_seconds * class cost_weight
    cloud_rate: float = 0.0             # r_cloud of the executing class
    n_credit: int = 0                   # cloud iterations banked by killed
                                        # attempts (replan-on-preemption)
    preemptions: int = 0                # times a spot reclaim killed its job
    window_joined: float = 0.0          # when it joined its current window
    where: object = None                # mobility only: the _Window or
                                        # _Job currently holding this
                                        # request (None = not replannable)


@dataclasses.dataclass(frozen=True, slots=True)
class CompletedRequest:
    request_id: str
    device_id: str
    arrival: float
    n_final: int
    r_dev: float
    rtt: float
    batched: bool
    window_wait: float
    queue_wait: float
    cloud_service: float
    gpu_seconds: float
    completion: float
    latency: float
    lower_bound: float                  # no-queue network+compute latency
    violated: bool
    gpu_class: str = ""
    gpu_cost: float = 0.0
    preemptions: int = 0                # spot reclaims that killed its job
    n_credit: int = 0                   # cloud iterations banked by replans


@dataclasses.dataclass(eq=False, slots=True)  # identity semantics: two
class _Job:                           # jobs are never "equal"; kill and
    group: int                        # remove must target THIS object
    members: List[SimRequest]
    service: float                      # wall seconds on one GPU
    submitted: float
    deadline: float = math.inf          # cloud-side finish deadline (EDF key)
    gpu_class: str = ""
    started: float = -1.0
    uid: int = 0                        # monotone submit ordinal
    killed: bool = False                # set by a spot reclaim; its pending
                                        # JOB_DONE event becomes a no-op


@dataclasses.dataclass(slots=True)
class _Window:
    group: int
    version: int
    members: List[SimRequest]
    flush_at: float


# --------------------------------------------------------------------------
# Per-class GPU pool
# --------------------------------------------------------------------------
class GpuPool:
    """One GPU class's pool: integer capacity that grows after a
    provisioning delay and releases only idle GPUs (§4.5's
    over-subscription story: freed GPUs go back to production jobs).

    Queue discipline: "fifo" (submission order) or "edf" (earliest
    ``_Job.deadline`` first).  Pre-refactor this class WAS the whole
    cloud; now one instance backs each ``GpuClass`` behind the
    ``HeterogeneousDispatcher``.
    """

    def __init__(self, n_init: int, min_gpus: int, max_gpus: int,
                 gpu_class: Optional[GpuClass] = None,
                 discipline: str = "fifo"):
        if discipline not in DISPATCH_MODES:
            raise ValueError(f"unknown queue discipline {discipline!r}; "
                             f"expected one of {DISPATCH_MODES}")
        self.gpu_class = gpu_class
        self.discipline = discipline
        self.capacity = max(n_init, min_gpus)
        self.min_gpus = min_gpus
        self.max_gpus = max_gpus
        self.busy = 0
        self.queue: deque = deque()     # fifo: _Job; edf uses the heaps
        self._heap: List[Tuple[float, int, _Job]] = []
        self._doomed: List[Tuple[float, int, _Job]] = []
        self._heap_seq = itertools.count()
        self.queued_service = 0.0       # running sum over queued jobs
        self.pending = 0                # GPUs being provisioned
        self.gpu_seconds = 0.0
        self.weighted_gpu_seconds = 0.0
        self.released_total = 0
        self.peak_capacity = self.capacity
        #: jobs holding a GPU (kill targets), keyed by object identity:
        #: completion removal is O(1) instead of an O(busy) list scan —
        #: at fleet scale thousands of GPUs are busy, and the old
        #: ``list.remove`` was a per-completion linear scan
        self.running: Dict[int, _Job] = {}
        self.reclaimed_total = 0        # GPUs lost to spot reclaim
        self.killed_total = 0           # running jobs killed by reclaim
        self._queue_dead = 0            # killed jobs still parked in the
                                        # queue structures (lazy cancel)
        self._busy_integral = 0.0
        self._cap_integral = 0.0
        self._last_t = 0.0

    @property
    def cost_weight(self) -> float:
        return self.gpu_class.cost_weight if self.gpu_class else 1.0

    def _advance(self, now: float) -> None:
        dt = now - self._last_t
        if dt > 0:
            self._busy_integral += self.busy * dt
            self._cap_integral += self.capacity * dt
            self._last_t = now

    def _start(self, now: float, job: _Job) -> float:
        self.busy += 1
        job.started = now
        self.running[id(job)] = job
        self.gpu_seconds += job.service
        self.weighted_gpu_seconds += job.service * self.cost_weight
        return now + job.service

    # -- queue discipline --------------------------------------------------
    def queue_len(self) -> int:
        # _queue_dead keeps the count exact under lazy cancellation, so
        # queue_len()-gated pop loops never drain an all-dead queue
        if self.discipline == "edf":
            return len(self._heap) + len(self._doomed) - self._queue_dead
        return len(self.queue) - self._queue_dead

    def _enqueue(self, job: _Job) -> None:
        if self.discipline == "edf":
            heapq.heappush(self._heap,
                           (job.deadline, next(self._heap_seq), job))
        else:
            self.queue.append(job)
        self.queued_service += job.service

    def _dequeue(self, now: float) -> _Job:
        if self.discipline == "edf":
            job = self._dequeue_edf(now)
        else:
            job = self.queue.popleft()
        self.queued_service -= job.service
        return job

    def _dequeue_edf(self, now: float) -> _Job:
        """Earliest-deadline-first WITH overload shedding: a job that can
        no longer win (even starting now it misses its deadline) yields
        to every still-winnable job, so one hopeless request cannot
        domino the whole queue into lateness — plain EDF famously
        degrades below FIFO under sustained overload without this.
        Doomed-ness is monotone (deadlines are fixed, time moves
        forward), so the lazy reclassification at pop time is sound.

        Boundedness: every ``_doomed`` entry is a LIVE queued job (it is
        counted by ``queue_len`` and accounted in ``queued_service``) —
        this is reclassification, not lazy deletion, so the two heaps
        together never exceed the live queue.  Entries for jobs killed
        externally are compacted away at pop time as a safeguard (today
        only running jobs are ever killed, so the guard is a no-op).
        """
        while self._heap:
            dl, seq, job = heapq.heappop(self._heap)
            if job.killed:                # compaction guard (see above)
                self.queued_service -= job.service
                self._queue_dead -= 1
                continue
            if now + job.service > dl + 1e-9:
                heapq.heappush(self._doomed, (dl, seq, job))
            else:
                return job
        while True:
            job = heapq.heappop(self._doomed)[2]
            if not job.killed:
                return job
            self.queued_service -= job.service
            self._queue_dead -= 1

    def _drain(self, now: float) -> List[Tuple[_Job, float]]:
        started = []
        if self.discipline == "fifo":
            # fast path: the common case is an empty queue after a
            # completion — one truthiness check, no method calls
            q = self.queue
            while q and self.busy < self.capacity:
                job = q.popleft()
                self.queued_service -= job.service
                if job.killed:            # lazily canceled while queued
                    self._queue_dead -= 1
                    continue
                started.append((job, self._start(now, job)))
            return started
        while self.queue_len() and self.busy < self.capacity:
            job = self._dequeue(now)
            started.append((job, self._start(now, job)))
        return started

    # -- public surface ----------------------------------------------------
    def submit(self, now: float, job: _Job) -> Optional[float]:
        """Returns the finish time when the job starts immediately, else
        queues it and returns None."""
        self._advance(now)
        if self.busy < self.capacity:
            return self._start(now, job)
        self._enqueue(job)
        return None

    def job_done(self, now: float,
                 job: Optional[_Job] = None) -> List[Tuple[_Job, float]]:
        self._advance(now)
        self.busy -= 1
        if job is not None:
            del self.running[id(job)]       # identity (eq=False on _Job)
        return self._drain(now)

    # -- spot reclaim (docs/preemption.md) ---------------------------------
    def reclaim(self, now: float, k: int) -> List[_Job]:
        """The provider takes ``k`` GPUs back: idle capacity goes first;
        if that does not cover it, the most-recently-started jobs are
        killed (their GPU vanishes mid-job).  Reclaim is external — it
        ignores ``min_gpus`` (the autoscaler re-provisions later).
        Returns the killed jobs; the caller must re-enter their members
        and ignore their pending JOB_DONE events (``job.killed``).
        Each killed job is refunded its UNUSED service (elapsed spot
        time stays billed — that work was burned, results lost)."""
        self._advance(now)
        k = min(k, self.capacity)
        if k <= 0:
            return []
        take_idle = min(k, self.capacity - self.busy)
        self.capacity -= take_idle
        self.reclaimed_total += take_idle
        need = k - take_idle
        killed: List[_Job] = []
        if need > 0:
            # heap-select the `need` most-recently-started jobs instead
            # of sorting the whole running set (O(n log need), not
            # O(n log n)); reversing restores the old ascending kill
            # order, so refund accumulation stays bit-identical
            victims = heapq.nlargest(need, self.running.values(),
                                     key=lambda j: (j.started, j.uid))[::-1]
            for job in victims:
                del self.running[id(job)]
                job.killed = True
                unused = job.service - (now - job.started)
                self.gpu_seconds -= unused
                self.weighted_gpu_seconds -= unused * self.cost_weight
                self.busy -= 1
                self.capacity -= 1
                self.reclaimed_total += 1
                self.killed_total += 1
                killed.append(job)
        return killed

    def evict_queue(self, now: float) -> List[_Job]:
        """Pop EVERY queued job (a fully reclaimed pool would strand its
        queue forever: jobs never migrate between class queues on their
        own) so the caller can re-route them."""
        self._advance(now)
        evicted: List[_Job] = []
        while self.queue_len():
            job = self._dequeue(now)
            if job.killed:                # lazily canceled while queued
                self._queue_dead -= 1
                continue
            evicted.append(job)
        return evicted

    def cancel(self, now: float, job: _Job) -> List[Tuple[_Job, float]]:
        """Withdraw one job this pool owns (mid-flight replan,
        serving/mobility.py).  Running: free its GPU, refund the UNUSED
        service (elapsed stays billed — that work was burned, mirroring
        ``reclaim``) and drain the queue into the freed slot.  Queued:
        lazy kill — the entry stays parked and is compacted at pop time
        (the same ``job.killed`` machinery spot reclaim uses); its
        pending JOB_DONE, if any, becomes a no-op."""
        self._advance(now)
        job.killed = True
        if self.running.pop(id(job), None) is not None:
            unused = job.service - (now - job.started)
            self.gpu_seconds -= unused
            self.weighted_gpu_seconds -= unused * self.cost_weight
            self.busy -= 1
            return self._drain(now)
        self._queue_dead += 1
        return []

    def add_capacity(self, now: float, k: int) -> List[Tuple[_Job, float]]:
        self._advance(now)
        self.capacity += k
        self.pending -= k
        self.peak_capacity = max(self.peak_capacity, self.capacity)
        return self._drain(now)

    def release_to(self, now: float, target: int) -> int:
        """Shrink toward ``target``, never below busy or min_gpus."""
        self._advance(now)
        target = max(target, self.busy, self.min_gpus)
        released = self.capacity - target
        if released > 0:
            self.capacity = target
            self.released_total += released
        return max(0, released)

    def queue_delay_estimate(self) -> float:
        """Rough wait a newly queued job would see (admission hint).
        O(1): queued_service is maintained incrementally."""
        if self.discipline == "fifo":             # queue_len, inlined
            if not self.queue:
                return 0.0
        elif not (self._heap or self._doomed):
            return 0.0
        return self.queued_service / max(1, self.capacity)

    def utilization(self, upto: float) -> float:
        self._advance(upto)
        return (self._busy_integral / self._cap_integral
                if self._cap_integral > 0 else 0.0)

    def snapshot_integrals(self) -> Tuple[float, float]:
        return self._busy_integral, self._cap_integral


# --------------------------------------------------------------------------
# Heterogeneous dispatcher: per-class pools behind one routing surface
# --------------------------------------------------------------------------
class HeterogeneousDispatcher:
    """Routes cloud jobs across per-class ``GpuPool``s.

    The routing RULE lives in the planner (``core.planner.RoutePolicy``
    — cheapest deadline-feasible class under "edf", first free class
    under "fifo"); this dispatcher owns the live queue state and asks
    the policy, instead of inlining the decision.

    Per-class service time comes from ``cloud_gpu_time(..., r_cloud=
    class rate)``, so a 0.5x spot GPU holds a job twice as long but at a
    lower $/GPU-s weight.
    """

    def __init__(self, capacity: CloudCapacity, p: CostParams,
                 discipline: str = "fifo",
                 route_policy: Optional[RoutePolicy] = None):
        if discipline not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch {discipline!r}; "
                             f"expected one of {DISPATCH_MODES}")
        self.capacity_spec = capacity
        self.p = p
        self.discipline = discipline
        self.deadline_aware = discipline == "edf"
        self.route_policy = route_policy if route_policy is not None else \
            RoutePolicy(capacity, p, deadline_aware=self.deadline_aware)
        self.pools: Dict[str, GpuPool] = {
            c.name: GpuPool(c.count, c.min_count, c.max_count, gpu_class=c,
                            discipline=discipline)
            for c in capacity}
        # from the CLAMPED pool capacities (max(count, min_count)), not
        # the raw class counts — min_count > count would under-report
        self.peak_capacity = self.total_capacity
        # single-class fast path: with one pool and the planner's
        # standard RoutePolicy, `choose` provably returns the only class
        # for every snapshot (free, queued, or empty+pending), so routing
        # skips the per-job snapshot construction entirely.  Custom
        # RoutePolicy subclasses always get the full path.
        self._single_pool: Optional[GpuPool] = (
            next(iter(self.pools.values())) if len(self.pools) == 1
            else None)
        self._single_class: Optional[GpuClass] = (
            self._single_pool.gpu_class
            if self._single_pool is not None
            and type(self.route_policy) is RoutePolicy else None)

    # -- aggregates --------------------------------------------------------
    @property
    def total_capacity(self) -> int:
        return sum(pl.capacity for pl in self.pools.values())

    @property
    def total_busy(self) -> int:
        return sum(pl.busy for pl in self.pools.values())

    @property
    def total_pending(self) -> int:
        return sum(pl.pending for pl in self.pools.values())

    @property
    def gpu_seconds(self) -> float:
        return sum(pl.gpu_seconds for pl in self.pools.values())

    @property
    def weighted_gpu_seconds(self) -> float:
        return sum(pl.weighted_gpu_seconds for pl in self.pools.values())

    @property
    def released_total(self) -> int:
        return sum(pl.released_total for pl in self.pools.values())

    @property
    def reclaimed_total(self) -> int:
        return sum(pl.reclaimed_total for pl in self.pools.values())

    @property
    def killed_total(self) -> int:
        return sum(pl.killed_total for pl in self.pools.values())

    def preemptible_pools(self) -> List[GpuPool]:
        """Pools whose class the provider may reclaim, in class order."""
        return [pl for pl in self.pools.values()
                if pl.gpu_class is not None and pl.gpu_class.preemptible]

    def queue_depth(self) -> int:
        return sum(pl.queue_len() for pl in self.pools.values())

    def current_counts(self) -> Dict[str, int]:
        return {name: pl.capacity for name, pl in self.pools.items()}

    def queue_delay_estimate(self) -> float:
        """Optimistic admission hint: the least-backed-up class."""
        if self._single_pool is not None:
            return self._single_pool.queue_delay_estimate()
        return min(pl.queue_delay_estimate() for pl in self.pools.values())

    def utilization(self, upto: float) -> float:
        busy = cap = 0.0
        for pl in self.pools.values():
            pl._advance(upto)
            b, c = pl.snapshot_integrals()
            busy += b
            cap += c
        return busy / cap if cap > 0 else 0.0

    def snapshot_integrals(self) -> Tuple[float, float]:
        busy = cap = 0.0
        for pl in self.pools.values():
            b, c = pl.snapshot_integrals()
            busy += b
            cap += c
        return busy, cap

    def advance(self, now: float) -> None:
        for pl in self.pools.values():
            pl._advance(now)

    # -- routing -----------------------------------------------------------
    def service_on(self, cls: GpuClass, n_final: int,
                   batch_factor: float) -> float:
        return self.route_policy.service_on(cls, n_final, batch_factor)

    def _snapshots(self) -> Dict[str, PoolSnapshot]:
        return {
            name: PoolSnapshot(
                free=pl.busy < pl.capacity,
                queue_delay=pl.queue_delay_estimate(),
                routable=pl.capacity + pl.pending > 0)
            for name, pl in self.pools.items()}

    def route(self, now: float, n_final: int, batch_factor: float,
              deadline: float) -> GpuClass:
        """Ask the planner's RoutePolicy for the executing class, given
        a snapshot of the live per-class queue state."""
        if self._single_class is not None:
            return self._single_class
        return self.route_policy.choose(now, n_final, batch_factor,
                                        deadline, self._snapshots())

    def submit(self, now: float, job: _Job) -> Optional[float]:
        pool = self.pools[job.gpu_class]
        return pool.submit(now, job)

    def job_done(self, now: float, job: _Job) -> List[Tuple[_Job, float]]:
        return self.pools[job.gpu_class].job_done(now, job)

    def add_capacity(self, now: float, name: str,
                     k: int) -> List[Tuple[_Job, float]]:
        started = self.pools[name].add_capacity(now, k)
        self.peak_capacity = max(self.peak_capacity, self.total_capacity)
        return started

    def per_class_stats(self, upto: float) -> Dict[str, Dict]:
        out = {}
        for name, pl in self.pools.items():
            out[name] = {
                "gpus": pl.capacity,
                "gpus_busy": pl.busy,
                "gpus_pending": pl.pending,
                "queue_depth": pl.queue_len(),
                "gpu_seconds": pl.gpu_seconds,
                "weighted_gpu_seconds": pl.weighted_gpu_seconds,
                "released": pl.released_total,
                "peak": pl.peak_capacity,
                "utilization": pl.utilization(upto),
                "preemptible": bool(pl.gpu_class.preemptible
                                    if pl.gpu_class else False),
                "reclaimed": pl.reclaimed_total,
                "killed_jobs": pl.killed_total,
            }
        return out


# --------------------------------------------------------------------------
# Result
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FleetSimResult:
    policy: str
    params: CostParams
    config: SimConfig
    completed: List[CompletedRequest]
    timeseries: List[Dict]
    n_arrivals: int
    violations: int
    total_gpu_seconds: float
    peak_gpus: int
    released_gpus: int
    final_gpus: int
    utilization: float
    total_gpu_cost: float = 0.0         # cost_weight-scaled GPU-seconds
    per_class: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    dispatch: str = "fifo"
    final_t_lim: float = 0.0            # t_lim after adaptive-SLA updates
    rejected: int = 0                   # shed at admission (never served)
    degraded: int = 0                   # shed to pure-local service
    preempted_gpus: int = 0             # GPUs reclaimed by the provider
    killed_jobs: int = 0                # running jobs killed by reclaim
    replans: int = 0                    # members re-planned after a kill
    #: streaming-stats sink when exact_stats=False (``completed`` stays
    #: empty; counts/percentiles come from here)
    stream: Optional[StreamingLatencyStats] = None
    n_events: int = 0                   # events the run loop processed
    plan_calls: int = 0                 # Planner.plan invocations
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    # mobility (serving.mobility; all zero with SimConfig.mobility=None)
    net_shifts: int = 0                 # NET_SHIFT events applied
    net_handoffs: int = 0               # WiFi<->cellular jumps
    net_disconnects: int = 0            # outage windows opened
    net_replans: int = 0                # mid-flight replans (degraded link)
    #: v2 only: did the chunked fast lane run?  None on v1; False names
    #: the blocking options in ``fast_lane_blockers`` (loud fallback)
    fast_lane: Optional[bool] = None
    fast_lane_blockers: List[str] = dataclasses.field(default_factory=list)
    # multiprocess cohort sharding (serving.shard_sim;
    # docs/sim_core_v2.md §Multiprocess sharding).  processes is the
    # worker count the run ACTUALLY used (1 when sharding fell back or
    # was never requested); shard_chunk_s the resolved barrier width
    # (None unsharded); per_shard one record per cohort shard —
    # arrivals/events/jobs/completed/violations/gpu_seconds and the
    # worker that ran it.  Counters in per_shard sum exactly to the
    # run-level fields.
    processes: int = 1
    shard_chunk_s: Optional[float] = None
    per_shard: List[Dict] = dataclasses.field(default_factory=list)
    #: per-worker peak RSS (MB, ru_maxrss) reported by each shard worker
    #: at exit — the memory side of the multiprocess bench cells
    worker_peak_rss_mb: List[float] = dataclasses.field(default_factory=list)

    def n_completed(self) -> int:
        return (self.stream.count if self.stream is not None
                else len(self.completed))

    def gpu_seconds_per_request(self) -> float:
        return self.total_gpu_seconds / max(1, self.n_completed())

    def gpu_cost_per_request(self) -> float:
        return self.total_gpu_cost / max(1, self.n_completed())

    def latency_percentile(self, q: float) -> float:
        """q in [0, 100].  Exact over the completed records by default;
        the P² estimate (tracked quantiles only) under streaming stats."""
        if self.stream is not None:
            return self.stream.percentile(q)
        return latency_percentile([c.latency for c in self.completed], q)

    def batched_fraction(self) -> float:
        n = self.n_completed()
        if not n:
            return 0.0
        if self.stream is not None:
            return self.stream.batched / n
        return sum(c.batched for c in self.completed) / n

    def violation_rate(self) -> float:
        return self.violations / max(1, self.n_completed())

    def plan_cache_hit_rate(self) -> float:
        total = self.plan_cache_hits + self.plan_cache_misses
        return self.plan_cache_hits / total if total else 0.0

    def to_json(self) -> Dict:
        return {
            "policy": self.policy,
            "dispatch": self.dispatch,
            "n_arrivals": self.n_arrivals,
            "n_completed": self.n_completed(),
            "violations": self.violations,
            "violation_rate": self.violation_rate(),
            "total_gpu_seconds": self.total_gpu_seconds,
            "total_gpu_cost": self.total_gpu_cost,
            "gpu_seconds_per_request": self.gpu_seconds_per_request(),
            "gpu_cost_per_request": self.gpu_cost_per_request(),
            "p50_latency": self.latency_percentile(50),
            "p99_latency": self.latency_percentile(99),
            "batched_fraction": self.batched_fraction(),
            "peak_gpus": self.peak_gpus,
            "released_gpus": self.released_gpus,
            "final_gpus": self.final_gpus,
            "utilization": self.utilization,
            "final_t_lim": self.final_t_lim,
            "rejected": self.rejected,
            "degraded": self.degraded,
            "preempted_gpus": self.preempted_gpus,
            "killed_jobs": self.killed_jobs,
            "replans": self.replans,
            "net_shifts": self.net_shifts,
            "net_handoffs": self.net_handoffs,
            "net_disconnects": self.net_disconnects,
            "net_replans": self.net_replans,
            "fast_lane": self.fast_lane,
            "fast_lane_blockers": self.fast_lane_blockers,
            "processes": self.processes,
            "shard_chunk_s": self.shard_chunk_s,
            "per_shard": self.per_shard,
            "worker_peak_rss_mb": self.worker_peak_rss_mb,
            "exact_stats": self.stream is None,
            "n_events": self.n_events,
            "plan_calls": self.plan_calls,
            "plan_cache_hits": self.plan_cache_hits,
            "plan_cache_misses": self.plan_cache_misses,
            "plan_cache_hit_rate": self.plan_cache_hit_rate(),
            "per_class": self.per_class,
            "timeseries": self.timeseries,
        }


# --------------------------------------------------------------------------
# Simulator
# --------------------------------------------------------------------------
def _make_arrivals(cfg: SimConfig) -> Iterator[float]:
    if cfg.process == "poisson":
        return poisson_arrivals(cfg.rate, cfg.duration, seed=cfg.seed,
                                max_rate=cfg.max_rate)
    if cfg.process == "bursty":
        return bursty_arrivals(cfg.rate, cfg.duration, seed=cfg.seed)
    if cfg.process == "diurnal":
        return diurnal_arrivals(cfg.rate, cfg.duration, seed=cfg.seed,
                                period_s=cfg.diurnal_period_s)
    raise ValueError(f"unknown arrival process {cfg.process!r}")


class FleetSimulator:
    def __init__(self, cfg: SimConfig):
        cfg.validate()
        self.cfg = cfg
        self.capacity_spec = cfg.build_capacity()
        # CostParams.r_cloud is the REFERENCE rate: for a heterogeneous
        # capacity the closed-form solves see the count-weighted mean;
        # for the default homogeneous pool this is exactly cfg.params.
        self.p = reference_params(cfg.params, self.capacity_spec)
        fleet = cfg.fleet
        if fleet is None:
            fleet = table4_fleet(seed=cfg.seed, params=self.p)
        if not fleet:
            raise ValueError("SimConfig.fleet is empty")
        if not cfg.autoscale and all(
                max(c.count, c.min_count) <= 0 for c in self.capacity_spec):
            # only the autoscaler can ever add capacity; a fixed empty
            # pool would queue cloud jobs forever and the run never ends
            raise ValueError("autoscale=False requires provisioned or "
                             "min capacity > 0")
        if cfg.preempt_requeue not in ("replan", "naive"):
            raise ValueError(f"unknown preempt_requeue "
                             f"{cfg.preempt_requeue!r}; expected "
                             f"'replan' or 'naive'")
        self._preempting = bool(cfg.preempt_rate > 0 or cfg.preempt_trace)
        if self._preempting and not cfg.autoscale and all(
                c.preemptible or max(c.count, c.min_count) <= 0
                for c in self.capacity_spec):
            # reclaim can zero an all-spot pool; with the autoscaler off
            # nothing ever replaces it and cloud jobs strand forever
            raise ValueError("preemption with autoscale=False requires "
                             "non-preemptible capacity > 0")
        # THE decision-maker: every per-request split / batching /
        # routing decision flows through this one Planner (the scheduler
        # and admission objects below are views into it, kept as
        # attributes for compat with pre-planner callers)
        # audit=False: this loop makes thousands of decisions per run
        # and keeps only the assignment + admission verdict — same
        # pipeline, same values, no per-decision trace/replay payloads
        # (build an audited Planner from the same config to inspect any
        # single decision)
        self.planner = Planner(
            self.p, policy=cfg.policy, capacity=self.capacity_spec,
            batch_size=cfg.batch_size,
            batch_model=BatchModel.from_timings(cfg.batch_timings)
            if cfg.batch_timings else None,
            worst_rtt=fleet[0].rtt, dispatch=cfg.dispatch, audit=False,
            shed_policy=ShedPolicy(queue_high=cfg.shed_queue_high,
                                   util_high=cfg.shed_util_high)
            if cfg.shedding else None,
            wire=cfg.wire,
            # plan memoization (core.planner.PlanCache): bit-identical
            # decisions, O(1) for repeat device profiles
            cache=cfg.plan_cache)
        self.scheduler = self.planner.scheduler
        self.admission = self.planner.admission
        self.fleet = fleet
        self.devices = fleet_sampler(fleet, seed=cfg.seed + 1,
                                     mode=cfg.sampling)
        self.arrivals = _make_arrivals(cfg)
        self.pool = HeterogeneousDispatcher(
            self.capacity_spec, self.p, discipline=cfg.dispatch,
            route_policy=self.planner.route_policy)
        # hot-path binding: skip the dispatcher aggregation layer when
        # there is only one pool (the per-arrival admission hint)
        self._queue_delay = (
            self.pool._single_pool.queue_delay_estimate
            if self.pool._single_pool is not None
            else self.pool.queue_delay_estimate)
        self.tracker = DeadlineTracker()
        # §7 adaptive SLA: observed utilization relaxes/tightens t_lim
        # for FUTURE arrivals (in-flight deadlines are contracts)
        self._t_lim_now = self.p.t_lim
        self.sla_ctl = None
        if cfg.adaptive_sla:
            self.sla_ctl = AdaptiveSLAController(
                SLAPolicy(t_lim=self.p.t_lim, t_floor=cfg.sla_floor,
                          t_ceil=cfg.sla_ceil),
                high_water=cfg.sla_high_water, low_water=cfg.sla_low_water)
        self._as_last_busy_int = 0.0
        self._as_last_cap_int = 0.0
        self.windows: Dict[int, _Window] = {}
        self._win_version = itertools.count()
        self._events: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        # sliding-horizon demand window for the §4.5 autoscaler:
        # (t, n_final, r_dev, rtt) — the profile terms feed the
        # deadline-aware per-class floors.  _wg_counts maintains the
        # window's per-group request counts INCREMENTALLY, so the
        # re-plan no longer rescans the whole window (w_group =
        # n * count is exact integer arithmetic — bit-identical to the
        # rescan it replaces)
        self._demand: deque = deque()
        self._wg_counts: Dict[int, int] = {}
        self.completed: List[CompletedRequest] = []
        #: fixed-memory stats sink (exact_stats=False); None keeps the
        #: exact completed-record path
        self.stream: Optional[StreamingLatencyStats] = (
            None if cfg.exact_stats else StreamingLatencyStats())
        self.timeseries: List[Dict] = []
        self.n_arrivals = 0
        self.n_events = 0
        self._recent_lat: List[float] = []   # since last metrics snapshot
        self._last_busy_int = 0.0
        self._last_cap_int = 0.0
        # spot preemption: a DEDICATED rng stream so enabling reclaim
        # never perturbs arrival/fleet sampling (and preempt_rate=0
        # never draws from it — the bit-identical anchor)
        self._preempt_rng = np.random.default_rng(cfg.seed + 0x5EED)
        self._job_uid = itertools.count()
        self._fastest_rate = max(c.r_cloud for c in self.capacity_spec)
        self.n_rejected = 0
        self.n_degraded = 0
        self.n_replans = 0
        # session network dynamics (serving.mobility): its OWN rng
        # stream, so mobility=None never draws and stays bit-identical
        self._mobility: Optional[MobilityModel] = (
            MobilityModel(cfg.mobility, fleet, cfg.seed)
            if cfg.mobility is not None else None)
        #: device_id -> {request_id: SimRequest} for requests whose
        #: cloud work is still in flight (the replan candidates)
        self._session_live: Dict[str, Dict[str, SimRequest]] = {}
        self.n_net_replans = 0
        # structured decision trace (serving.replay): every write is
        # behind `if self._trace is not None`, so the default path adds
        # one predictable branch per hook and no allocation
        self._trace = None
        if cfg.trace_out:
            from repro_torch.serving.replay import TraceWriter
            self._trace = TraceWriter(
                cfg.trace_out, self.planner.config_json(),
                {"seed": cfg.seed, "policy": cfg.policy,
                 "process": cfg.process, "rate": cfg.rate,
                 "duration": cfg.duration, "batch_size": cfg.batch_size,
                 "window_s": cfg.window_s, "dispatch": cfg.dispatch,
                 "preempt_rate": cfg.preempt_rate,
                 "preempt_requeue": cfg.preempt_requeue,
                 "shedding": cfg.shedding,
                 "adaptive_sla": cfg.adaptive_sla,
                 "mobility": cfg.mobility.to_json()
                 if cfg.mobility is not None else None})

    # -- event plumbing ----------------------------------------------------
    def _push(self, t: float, kind: int, payload=None) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), payload))

    def _active(self) -> bool:
        """Recurring events re-arm only while there is anything left to
        observe; this is what lets the heap drain and the run terminate."""
        return self._next_arrival is not None or self.tracker.in_flight() > 0

    def _arm_recurring(self, cfg: SimConfig) -> None:
        """Initial pushes of the recurring/scripted event streams (shared
        by both cores; called right after the first arrival is armed so
        the v1 tie-break ordinals are unchanged)."""
        if cfg.autoscale:
            self._push(cfg.autoscale_interval_s, EVT_AUTOSCALE)
        self._push(cfg.metrics_interval_s, EVT_METRICS)
        if cfg.preempt_trace:
            preemptible = {pl.gpu_class.name
                           for pl in self.pool.preemptible_pools()}
            for when, name, k in cfg.preempt_trace:
                if name not in self.pool.pools:
                    raise ValueError(f"preempt_trace names unknown class "
                                     f"{name!r}")
                if name not in preemptible:
                    # a typo'd class name must not silently reclaim
                    # RESERVED capacity the provider cannot take
                    raise ValueError(f"preempt_trace targets "
                                     f"non-preemptible class {name!r}")
                self._push(float(when), EVT_PREEMPT, (name, int(k)))
        if cfg.preempt_rate > 0:
            self._arm_preempt(0.0)
        if self._mobility is not None:
            self._arm_net_shift(0.0)

    # -- main loop ---------------------------------------------------------
    def run(self) -> FleetSimResult:
        cfg = self.cfg
        self._next_arrival = next(self.arrivals, None)
        if self._next_arrival is not None:
            self._push(self._next_arrival, EVT_ARRIVAL)
        self._arm_recurring(cfg)

        # hot loop: table dispatch (handlers indexed by event kind) with
        # the heap and pop bound to locals — this loop runs millions of
        # times per fleet-scale simulation
        handlers = (self._on_capacity, self._on_job_done,
                    self._on_arrival, self._on_window, self._on_autoscale,
                    self._on_complete, self._on_metrics, self._on_preempt,
                    self._on_net_shift)
        events = self._events
        pop = heapq.heappop
        t = 0.0
        while events:
            t, kind, _, payload = pop(events)
            handlers[kind](t, payload)
        last_t = t
        # the heap drained, so pops == pushes: the push ordinal counter
        # IS the processed-event count
        self.n_events = next(self._seq)
        if self._trace is not None:
            self._trace.close()
        return self._build_result(last_t)

    def _build_result(self, last_t: float) -> FleetSimResult:
        cfg = self.cfg
        # integrate through the final event so the trailing idle window
        # (device tails after the last cloud job) counts toward the mean
        util = self.pool.utilization(upto=last_t)
        cache = self.planner.cache
        return FleetSimResult(
            policy=cfg.policy, params=self.p, config=cfg,
            completed=self.completed, timeseries=self.timeseries,
            n_arrivals=self.n_arrivals, violations=self.tracker.violations,
            total_gpu_seconds=self.pool.gpu_seconds,
            peak_gpus=self.pool.peak_capacity,
            released_gpus=self.pool.released_total,
            final_gpus=self.pool.total_capacity, utilization=util,
            total_gpu_cost=self.pool.weighted_gpu_seconds,
            per_class=self.pool.per_class_stats(last_t),
            dispatch=cfg.dispatch, final_t_lim=self._t_lim_now,
            rejected=self.n_rejected, degraded=self.n_degraded,
            preempted_gpus=self.pool.reclaimed_total,
            killed_jobs=self.pool.killed_total, replans=self.n_replans,
            stream=self.stream, n_events=self.n_events,
            plan_calls=self.planner.plan_calls,
            plan_cache_hits=cache.hits if cache else 0,
            plan_cache_misses=cache.misses if cache else 0,
            net_shifts=self._mobility.n_shifts if self._mobility else 0,
            net_handoffs=self._mobility.n_handoffs if self._mobility else 0,
            net_disconnects=(self._mobility.n_disconnects
                             if self._mobility else 0),
            net_replans=self.n_net_replans,
            fast_lane=getattr(self, "_fast_lane", None),
            fast_lane_blockers=list(getattr(self, "_fast_blockers_rec",
                                            ())),
            processes=getattr(self, "_shard_processes", 1),
            shard_chunk_s=getattr(self, "_shard_chunk_s", None),
            per_shard=list(getattr(self, "_per_shard", ())),
            worker_peak_rss_mb=list(getattr(self, "_worker_rss_mb", ())))

    # -- adaptive SLA ------------------------------------------------------
    def _set_t_lim(self, t_lim: float) -> None:
        """Apply a new SLA target to FUTURE arrivals via the planner's
        §7 hook: the per-request solver (scheduler) and the batching
        admission both see it; in-flight deadlines are unchanged (they
        are contracts fixed at arrival — see core.sla.RequestDeadline)."""
        if t_lim == self._t_lim_now:
            return
        self._t_lim_now = t_lim
        self.planner.set_t_lim(t_lim, source="adaptive(§7)")

    # -- handlers ----------------------------------------------------------
    def _on_arrival(self, t: float, _payload=None) -> None:
        prof = next(self.devices)
        if self._mobility is not None:
            # the planner sees the session's LIVE link, not the fleet
            # anchor (an outage adds its remaining wait to the rtt)
            prof = self._mobility.live_profile(prof, t)
        rid = f"r{self.n_arrivals}"
        self.n_arrivals += 1
        # one request in, one decision out: split solve, quantization,
        # batching admission, load shedding (and the advisory class
        # route) all come from the planner pipeline in a single call —
        # plan_profile is the cached hot entry (no PlanRequest wrapper)
        util_hint = 0.0
        if self.planner.shed_policy is not None:
            cap_now = self.pool.total_capacity
            util_hint = self.pool.total_busy / cap_now if cap_now else 1.0
        qd_hint = self._queue_delay()
        decision = self.planner.plan_profile(prof, qd_hint, util_hint)
        if self._trace is not None:
            self._trace.plan(t, rid, dataclasses.asdict(prof), qd_hint,
                             util_hint, decision)
        if decision.action == "reject":
            # shed at admission: refused up front (no deadline opens, no
            # demand recorded — the autoscaler must not size for it)
            self.n_rejected += 1
            self._schedule_next_arrival()
            return
        if decision.action == "degrade-to-local":
            self.n_degraded += 1
        a = decision._assignment     # always live in hot-loop decisions
        nf = a.n_final
        req = SimRequest(request_id=rid, arrival=t, profile=prof,
                         assignment=a)
        self.tracker.open(rid, t, self._t_lim_now)
        self._demand.append((t, nf, prof.r_dev, prof.rtt))
        self._wg_counts[nf] = self._wg_counts.get(nf, 0) + 1

        if nf <= 0:
            # device-only: no cloud resources at all
            done = t + e2e_latency(0, prof.r_dev, self.p, prof.rtt,
                                   c_batch=1.0)
            self._push(done, EVT_COMPLETE, req)
        else:
            if self._mobility is not None:
                # cloud work in flight: a NET_SHIFT on this session may
                # pull the request back through the planner
                self._session_live.setdefault(prof.device_id, {})[rid] = req
            if decision.batch_admit:
                self._join_window(t, req, decision.batch_max_wait)
            else:
                self._dispatch(t, [req])

        self._schedule_next_arrival()

    def _schedule_next_arrival(self) -> None:
        nxt = self._next_arrival = next(self.arrivals, None)
        if nxt is not None:                       # inlined _push
            heapq.heappush(self._events,
                           (nxt, EVT_ARRIVAL, next(self._seq), None))

    def _join_window(self, t: float, req: SimRequest,
                     max_wait: float) -> None:
        req.window_joined = t
        g = self.scheduler.group_key(req.assignment)
        w = self.windows.get(g)
        stale_deadline = t + min(self.cfg.window_s, max_wait)
        if w is None:
            w = _Window(group=g, version=next(self._win_version),
                        members=[req], flush_at=stale_deadline)
            self.windows[g] = w
            if self._mobility is not None:
                req.where = w
            self._push(w.flush_at, EVT_WINDOW, (g, w.version))
            return
        w.members.append(req)
        if self._mobility is not None:
            req.where = w
        if len(w.members) >= self.cfg.batch_size:
            self._flush_window(t, w)
        elif stale_deadline < w.flush_at:
            # the new member is tighter than the current flush deadline
            w.flush_at = stale_deadline
            self._push(w.flush_at, EVT_WINDOW, (g, w.version))

    def _on_window(self, t: float, payload) -> None:
        g, version = payload
        w = self.windows.get(g)
        # stale event: window already flushed (by size or an earlier,
        # tightened deadline) and possibly reopened since
        if w is None or w.version != version or t < w.flush_at - 1e-12:
            return
        self._flush_window(t, w)

    def _flush_window(self, t: float, w: _Window) -> None:
        del self.windows[w.group]
        for m in w.members:
            # time spent in THIS window (== t - arrival pre-preemption;
            # a replanned member may re-window long after arrival)
            m.window_wait += t - m.window_joined
        self._dispatch(t, w.members)

    def _cloud_deadline(self, members: List[SimRequest]) -> float:
        """Latest time the CLOUD part may finish: the tightest member's
        e2e deadline (from the DeadlineTracker clock opened at arrival)
        minus its post-cloud tail (rtt + remaining device iterations +
        decode).  ``n_credit`` iterations banked by killed attempts
        shrink the device tail (replan-on-preemption)."""
        dl = math.inf
        tracker_get = self.tracker.get
        n_total = self.p.n_total
        k_decode = self.p.k_decode
        for m in members:
            d = tracker_get(m.request_id)
            if d is None:
                continue
            prof = m.profile
            r_dev = prof.r_dev
            # m.assignment.t_network == prof.rtt + the wire format's
            # transfer delta (identical to prof.rtt with the wire stage
            # off), so the deadline prices the ship the plan chose
            tail = (m.assignment.t_network
                    + (n_total - m.assignment.n_final - m.n_credit)
                    / r_dev
                    + k_decode / r_dev)
            cand = d.deadline - tail
            if cand < dl:
                dl = cand
        return dl

    def _dispatch(self, t: float, members: List[SimRequest]) -> None:
        """Submit one cloud job for ``members`` (same n_final group)."""
        n_final = members[0].assignment.n_final
        b = len(members)
        batched = b >= 2
        # a batch of b runs at the batch-b slowdown: the planner owns
        # the batching constants (the §4.4 extrapolation from the pinned
        # batch-2 measurement, or the fitted BatchModel when calibrated
        # timings were given); a solo run pays no batching penalty
        cb = self.planner.c_batch_of(b) if batched else 1.0
        deadline = self._cloud_deadline(members)
        cls = self.pool.route(t, n_final, cb, deadline)
        # inlined route_policy.service_on -> cloud_gpu_time (same
        # expression: n_final * batch_factor / class rate)
        cls_rate = cls.r_cloud
        service = n_final * cb / cls_rate
        # ACCUMULATE shares (x += y is bit-identical to x = y from the
        # 0.0 defaults): a preempted member's earlier attempts already
        # charged it for the spot time they burned
        share = service / b
        cls_name = cls.name
        cost = share * cls.cost_weight
        for m in members:
            m.batched = batched
            m.batch_slowdown = cb
            m.cloud_service += service
            m.gpu_seconds += share
            m.gpu_class = cls_name
            m.gpu_cost += cost
            m.cloud_rate = cls_rate
        if self._trace is not None:
            self._trace.dispatch(t, n_final,
                                 [m.request_id for m in members], cb,
                                 cls_name, cls_rate, service, deadline)
        job = _Job(group=n_final, members=members, service=service,
                   submitted=t, deadline=deadline, gpu_class=cls.name,
                   uid=next(self._job_uid))
        if self._mobility is not None:
            for m in members:
                m.where = job
        finish = self.pool.submit(t, job)
        if finish is not None:
            self._push(finish, EVT_JOB_DONE, job)

    def _on_job_done(self, t: float, job: _Job) -> None:
        if job.killed:
            # a spot reclaim killed this job after its JOB_DONE event
            # was scheduled; the pool already forgot it and the members
            # were re-entered at kill time
            return
        qw = job.started - job.submitted
        n_total = self.p.n_total
        k_decode = self.p.k_decode
        events = self._events
        seq = self._seq
        push = heapq.heappush                     # inlined _push
        mob = self._mobility
        for m in job.members:
            m.queue_wait += qw
            prof = m.profile
            r_dev = prof.r_dev
            if mob is None:
                rtt = prof.rtt
            else:
                # results ship over the session's LIVE link (an outage
                # adds its remaining wait), not the rtt planned at
                # arrival — this is what the freeze-at-arrival baseline
                # pays for not replanning
                rtt = mob.ship_rtt(prof.device_id, t, prof.rtt)
                m.where = None
            # the selected wire format's transfer delta rides the ship
            # (Assignment.t_network = planned rtt + t_wire; exactly 0.0
            # apart with the wire stage off, keeping the pre-wire event
            # dynamics bit-identical)
            wire_dt = m.assignment.t_network - prof.rtt
            if wire_dt != 0.0:
                rtt += wire_dt
            done = (t + rtt
                    + (n_total - m.assignment.n_final - m.n_credit)
                    / r_dev
                    + k_decode / r_dev)
            push(events, (done, EVT_COMPLETE, next(seq), m))
        for nxt, finish in self.pool.job_done(t, job):
            push(events, (finish, EVT_JOB_DONE, next(seq), nxt))

    def _on_capacity(self, t: float, payload) -> None:
        name, k = payload
        for job, finish in self.pool.add_capacity(t, name, k):
            self._push(finish, EVT_JOB_DONE, job)

    # -- spot preemption (docs/preemption.md) ------------------------------
    def _arm_preempt(self, t: float) -> None:
        """Schedule the next Poisson reclaim.  The hazard is
        ``preempt_rate`` per PROVISIONED preemptible GPU, evaluated at
        arming time (the standard event-driven approximation: the rate
        lags capacity changes by at most one reclaim interval).  With no
        spot capacity provisioned yet, poll at the autoscale cadence
        without consuming randomness."""
        cap_p = sum(pl.capacity for pl in self.pool.preemptible_pools())
        rate = self.cfg.preempt_rate * cap_p
        if rate > 0:
            gap = float(self._preempt_rng.exponential(1.0 / rate))
        else:
            gap = self.cfg.autoscale_interval_s
        self._push(t + gap, EVT_PREEMPT, None)

    def _on_preempt(self, t: float, payload) -> None:
        """A reclaim fires: ``payload`` is ``(class_name, k)`` for a
        scripted trace event, or None for a Poisson event (one GPU from
        a preemptible pool drawn capacity-proportionally)."""
        if payload is None:
            pools = [pl for pl in self.pool.preemptible_pools()
                     if pl.capacity > 0]
            if pools:
                caps = np.array([pl.capacity for pl in pools], float)
                idx = int(self._preempt_rng.choice(
                    len(pools), p=caps / caps.sum()))
                self._reclaim_from(t, pools[idx], 1)
            if self._active() and self.cfg.preempt_rate > 0:
                self._arm_preempt(t)
            return
        name, k = payload
        self._reclaim_from(t, self.pool.pools[name], k)

    def _reclaim_from(self, t: float, pool: GpuPool, k: int) -> None:
        killed = pool.reclaim(t, k)
        if pool.capacity == 0 and pool.queue_len():
            # a fully reclaimed pool would strand its queue forever
            # (jobs never migrate between class queues on their own):
            # evict and re-route through the same requeue path.  Queued
            # jobs never started, so their members are refunded in full.
            killed += pool.evict_queue(t)
        if self._trace is not None:
            # before the requeue, so the preempt record precedes the
            # replan/dispatch records it causes (file order = causality)
            self._trace.preempt(t, pool.gpu_class.name, k, len(killed))
        self._requeue_killed(t, killed)

    def _requeue_killed(self, t: float, killed: List[_Job]) -> None:
        for job in killed:
            b = len(job.members)
            started = job.started >= 0
            elapsed = (t - job.started) if started else 0.0
            unused = job.service - elapsed
            cls = self.capacity_spec[job.gpu_class]
            # refund each member's share of the service that will never
            # run (mirrors the pool-level refund in GpuPool.reclaim;
            # elapsed spot time stays billed), keep cloud_service at the
            # wall time the attempt ACTUALLY consumed, and bank the
            # killed attempt's queue wait (its JOB_DONE never fires)
            for m in job.members:
                m.gpu_seconds -= unused / b
                m.gpu_cost -= (unused / b) * cls.cost_weight
                m.cloud_service -= unused
                m.queue_wait += (job.started if started else t) \
                    - job.submitted
                m.preemptions += 1
            if self.cfg.preempt_requeue == "naive":
                # full restart: same split, no credit, original deadline
                # — re-routes (possibly to another class) and requeues
                self._dispatch(t, job.members)
                continue
            # replan: iterations the killed attempt banked (the batch
            # progressed jointly at the class rate / batch slowdown)
            cb = job.members[0].batch_slowdown if started else 1.0
            n_done = int(elapsed * cls.r_cloud / cb) if started else 0
            n_done = max(0, min(job.group, n_done))
            self._replan_members(t, job.members, n_done)

    def _replan_members(self, t: float, members: List[SimRequest],
                        n_done: int, source: str = "preempt") -> None:
        """Re-enter killed members through the planner: elapsed-time
        credit (``n_done`` banked iterations each) under each member's
        tightened remaining deadline.  The replan decides where the
        REMAINING work runs — more cloud iterations or a pure-local
        finish — and the §4.4 admission applies under the TIGHTENED
        budget, so a member with slack rejoins its group's batching
        window (merging back into normal flow) while a tight one
        dispatches now.  Tight members whose replans land in the same
        quantized group re-dispatch as ONE batch: re-splitting a killed
        batch into solo jobs would multiply the queue load the reclaim
        caused.

        ``source="net-shift"`` (serving.mobility) routes through
        ``planner.replan_degraded`` instead: the same elapsed-credit
        machinery, but the member's profile carries the LIVE link and
        the shed valve stays active — a hopeless link degrades to a
        pure-local finish instead of shipping a split that cannot land
        (an admitted request is never dropped: "reject" here means no
        further cloud service, not no service)."""
        regroup: Dict[int, List[SimRequest]] = {}
        net = source != "preempt"
        for m in members:
            m.n_credit += n_done
            d = self.tracker.get(m.request_id)
            time_left = (d.deadline - t) if d is not None else 0.0
            qd_hint = self.pool.queue_delay_estimate()
            util_hint = 0.0
            if net:
                if self.planner.shed_policy is not None:
                    cap_now = self.pool.total_capacity
                    util_hint = (self.pool.total_busy / cap_now
                                 if cap_now else 1.0)
                decision = self.planner.replan_degraded(
                    PlanRequest(
                        device=m.profile, request_id=m.request_id,
                        queue_delay_hint=qd_hint,
                        utilization_hint=util_hint),
                    n_done=m.n_credit, time_left=time_left)
            else:
                decision = self.planner.replan_preempted(
                    PlanRequest(
                        device=m.profile, request_id=m.request_id,
                        queue_delay_hint=qd_hint),
                    n_done=m.n_credit, time_left=time_left)
            if self._trace is not None:
                self._trace.replan(t, m.request_id,
                                   dataclasses.asdict(m.profile),
                                   m.n_credit, time_left, qd_hint,
                                   decision, source=source,
                                   utilization_hint=util_hint)
            self.n_replans += 1
            if net:
                self.n_net_replans += 1
                if decision.action == "degrade-to-local":
                    self.n_degraded += 1
            if decision.action == "reject":
                # mid-flight shed: no winnable cloud plan remains; the
                # device finishes the remainder best-effort
                m.assignment = dataclasses.replace(
                    decision.assignment(), n_final=0)
            else:
                m.assignment = decision.assignment()
            if m.assignment.n_final <= 0:
                # the device can finish the remainder inside the budget
                # (or nothing remains): ship the partial latent + decode
                if self._mobility is not None:
                    m.where = None
                done = (t + m.profile.rtt
                        + (self.p.n_total - m.n_credit) / m.profile.r_dev
                        + self.p.k_decode / m.profile.r_dev)
                self._push(done, EVT_COMPLETE, m)
            elif decision.batch_admit:
                self._join_window(t, m, decision.batch_max_wait)
            else:
                regroup.setdefault(m.assignment.n_final, []).append(m)
        for group in regroup.values():
            self._dispatch(t, group)

    # -- session network dynamics (serving.mobility) -----------------------
    def _arm_net_shift(self, t: float) -> None:
        """Schedule the next fleet-wide network shift (the superposed
        per-session Poisson process, on the mobility rng stream)."""
        gap = self._mobility.next_gap()
        if gap is not None:
            self._push(t + gap, EVT_NET_SHIFT, None)

    def _on_net_shift(self, t: float, payload) -> None:
        """A session's link shifts.  ``payload`` is None for a drawn
        shift (drift / handoff / disconnect) or a device_id for a
        scheduled reconnect (the outage window closing — bookkeeping
        only, no rng).  With ``mobility.replan`` the shifted session's
        in-flight requests re-enter the planner when the link moved past
        the replan thresholds; without it (the freeze-at-arrival
        baseline) the SAME shift sequence plays out and stale splits pay
        the live link at ship time."""
        mob = self._mobility
        if mob is None:
            return
        if payload is not None:
            link = mob.sessions[payload]
            if link.down_until and t >= link.down_until - 1e-9:
                shift = mob.reconnect(t, payload)
                if self._trace is not None:
                    self._trace.net_shift(t, shift.to_json())
            return
        shift = mob.step(t)
        if shift is not None:
            if self._trace is not None:
                self._trace.net_shift(t, shift.to_json())
            if shift.kind == "disconnect":
                self._push(shift.down_until, EVT_NET_SHIFT,
                           shift.device_id)
            if mob.cfg.replan:
                self._net_replan_session(t, shift.device_id)
        if self._active():
            self._arm_net_shift(t)

    def _net_replan_session(self, t: float, device_id: str) -> None:
        """Pull the shifted session's DEGRADED in-flight requests out of
        wherever they are parked (batching window or cloud job) and
        re-enter each through ``_replan_members(source="net-shift")``.

        Accounting mirrors ``_requeue_killed``: a withdrawn member banks
        ``n_done`` credit for cloud iterations its started job already
        ran, refunds modeled service that will never run for it, and
        keeps what was burned.  One deliberate conservatism: when a
        member leaves a multi-member batch that keeps running, its slot
        still burns modeled GPU time (the batch's service is unchanged)
        — withdrawing mid-batch is not free.
        """
        mob = self._mobility
        live = self._session_live.get(device_id)
        if not live:
            return
        for m in list(live.values()):
            loc = m.where
            if loc is None:
                continue
            prof = m.profile
            if not mob.degraded(device_id, prof.rtt, prof.bandwidth, t):
                continue
            n_done = 0
            if isinstance(loc, _Window):
                # still batching: leave the window (delete it if emptied
                # — its pending EVT_WINDOW goes stale via the version
                # check) and bank the wait
                loc.members.remove(m)
                m.window_wait += t - m.window_joined
                if not loc.members:
                    del self.windows[loc.group]
            else:
                job: _Job = loc
                if job.killed:              # already canceled/reclaimed
                    m.where = None
                    continue
                b = len(job.members)
                job.members.remove(m)
                cls = self.capacity_spec[job.gpu_class]
                started = job.started >= 0
                if started:
                    elapsed = t - job.started
                    unused = job.service - elapsed
                    n_done = max(0, min(job.group,
                                        int(elapsed * cls.r_cloud
                                            / m.batch_slowdown)))
                    m.cloud_service -= unused
                    m.queue_wait += job.started - job.submitted
                else:
                    unused = job.service
                    m.cloud_service -= job.service
                    m.queue_wait += t - job.submitted
                if b == 1:
                    # sole member: cancel the job outright.  Running:
                    # the pool refunds the unused service and backfills
                    # the freed GPU; queued: lazy kill, compacted at pop
                    m.gpu_seconds -= unused
                    m.gpu_cost -= unused * cls.cost_weight
                    for nxt, finish in self.pool.pools[
                            job.gpu_class].cancel(t, job):
                        self._push(finish, EVT_JOB_DONE, nxt)
            m.where = None
            m.profile = mob.live_profile(prof, t)
            self._replan_members(t, [m], n_done, source="net-shift")

    def _preempt_discounts(self) -> Optional[Dict[str, float]]:
        """Per-class effective-rate discounts for the §4.5 re-plan:
        expected useful throughput of a spot GPU under the configured
        Poisson reclaim hazard (``capacity.preemption_discount``).  The
        expected job length uses the demand window's mean group size at
        the configured batch slowdown; replans carry elapsed-time
        credit, so only naive requeue charges the half-job restart
        loss.  None when preemption is off."""
        cfg = self.cfg
        if cfg.preempt_rate <= 0:
            return None
        loss = 0.5 if cfg.preempt_requeue == "naive" else 0.0
        groups = [n for _, n, _, _ in self._demand if n > 0]
        mean_n = sum(groups) / len(groups) if groups else float(
            self.p.n_total)
        cb = (self.planner.c_batch_of(cfg.batch_size)
              if self.admission is not None else 1.0)
        return {
            c.name: preemption_discount(
                cfg.preempt_rate, provision_delay_s=cfg.provision_delay_s,
                job_s=mean_n * cb / c.r_cloud, restart_loss=loss)
            for c in self.capacity_spec if c.preemptible}

    def _on_autoscale(self, t: float, _payload=None) -> None:
        cfg = self.cfg
        if self.sla_ctl is not None:
            # couple the §7 controller to utilization observed since the
            # last re-plan: sustained pressure relaxes t_lim (more device
            # work per request) instead of violating deadlines
            self.pool.advance(t)
            busy_int, cap_int = self.pool.snapshot_integrals()
            d_busy = busy_int - self._as_last_busy_int
            d_cap = cap_int - self._as_last_cap_int
            self._as_last_busy_int = busy_int
            self._as_last_cap_int = cap_int
            if d_cap > 0:
                self._set_t_lim(self.sla_ctl.update(d_busy / d_cap))
        demand = self._demand
        wg_counts = self._wg_counts
        expire = t - cfg.horizon_s
        while demand and demand[0][0] < expire:
            _, n, _, _ = demand.popleft()
            wg_counts[n] -= 1
        # early in the run the deque spans less than horizon_s of
        # arrivals; dividing by the full horizon would underestimate
        # demand ~(horizon/t)x and release the warm pool into a queue
        # transient — normalize by the window actually observed
        seen = min(cfg.horizon_s, t)
        # w_group = n * count from the incremental window counts (exact
        # integer arithmetic inside plan_capacity_targets — bit-identical
        # to the full-window rescan it replaced).  The same demand
        # window, with per-request device profiles: deadline-aware
        # floors keep spot-first scaling from starving the reserved
        # class when spot is too slow for tight deadlines (no-op for a
        # homogeneous pool — the golden-trace anchor).
        # planner.p, not self.p: under adaptive SLA the floors must
        # judge feasibility against the t_lim new arrivals are actually
        # being solved for (same r_cloud, so the supply sizing is
        # unchanged)
        plan = plan_capacity_targets(
            cfg.policy, wg_counts, self.planner.p, self.capacity_spec,
            current=self.pool.current_counts(), horizon_s=seen,
            headroom=cfg.headroom,
            release_threshold=cfg.release_threshold,
            # lazily iterated once by deadline_floors, in window order
            # (floats must accumulate in the same order as the old
            # materialized list); a homogeneous capacity returns before
            # consuming it at all
            demands=((n, r_dev, rtt)
                     for _, n, r_dev, rtt in self._demand),
            # feasibility at the slowdown jobs actually run at: batched
            # jobs hold a slow class longer, which is what starves the
            # reserved slice under blind spot-first scaling
            demand_c_batch=self.planner.c_batch_of(cfg.batch_size)
            if self.admission is not None else 1.0,
            # preemption-aware headroom: spot supply is discounted by
            # the expected reclaim loss, so meeting the same demand
            # provisions extra spot GPUs (None when preempt_rate=0 —
            # the bit-identical anchor)
            rate_discounts=self._preempt_discounts())
        for name, target in plan.targets.items():
            pl = self.pool.pools[name]
            provisioned_total = pl.capacity + pl.pending
            if target > provisioned_total:
                k = target - provisioned_total
                pl.pending += k
                self._push(t + cfg.provision_delay_s, EVT_CAPACITY,
                           (name, k))
            elif plan.release_gpus and target < pl.capacity:
                pl.release_to(t, target)
        if self._active():
            self._push(t + cfg.autoscale_interval_s, EVT_AUTOSCALE)

    def _on_complete(self, t: float, req: SimRequest) -> None:
        if self._mobility is not None:
            live = self._session_live.get(req.profile.device_id)
            if live is not None:
                live.pop(req.request_id, None)
        late = self.tracker.close(req.request_id, t)
        latency = t - req.arrival
        if self.stream is not None:
            # streaming stats (exact_stats=False): fixed-memory counters
            # + P² percentiles instead of a grow-forever record list (the
            # lower-bound audit column lives only on exact records)
            self.stream.add(latency, req.batched)
            self._recent_lat.append(latency)
            return
        a = req.assignment
        prof = req.profile
        # no-queue latency floor at the rate the job actually ran (waits
        # and queues only ADD to this)
        if req.n_credit > 0:
            # preempted + replanned: attempts may have run on different
            # classes, so the only safe floor counts ALL cloud
            # iterations (banked + final) at the fastest class's solo
            # rate
            lower = e2e_latency(req.n_credit + a.n_final,
                                prof.r_dev, self.p,
                                prof.rtt, c_batch=1.0,
                                r_cloud=self._fastest_rate)
        else:
            lower = e2e_latency(a.n_final, prof.r_dev, self.p,
                                prof.rtt,
                                c_batch=req.batch_slowdown,
                                r_cloud=req.cloud_rate or None)
        self.completed.append(CompletedRequest(
            request_id=req.request_id, device_id=prof.device_id,
            arrival=req.arrival, n_final=a.n_final,
            r_dev=prof.r_dev, rtt=prof.rtt,
            batched=req.batched, window_wait=req.window_wait,
            queue_wait=req.queue_wait, cloud_service=req.cloud_service,
            gpu_seconds=req.gpu_seconds, completion=t,
            latency=latency, lower_bound=lower, violated=late,
            gpu_class=req.gpu_class, gpu_cost=req.gpu_cost,
            preemptions=req.preemptions, n_credit=req.n_credit))
        self._recent_lat.append(latency)

    def _on_metrics(self, t: float, _payload=None) -> None:
        self.pool.advance(t)
        busy_int, cap_int = self.pool.snapshot_integrals()
        d_busy = busy_int - self._last_busy_int
        d_cap = cap_int - self._last_cap_int
        self._last_busy_int, self._last_cap_int = busy_int, cap_int
        lats = self._recent_lat
        self._recent_lat = []

        def pct(q):
            # same definition as FleetSimResult.latency_percentile
            # (telemetry.latency_percentile), so snapshot and run-level
            # percentiles agree
            if not lats:
                return None
            return latency_percentile(lats, q * 100.0)

        self.timeseries.append({
            "t": t,
            "arrivals": self.n_arrivals,
            "completed": self.tracker.completed,
            "in_flight": self.tracker.in_flight(),
            "violations": self.tracker.violations,
            "p50_latency": pct(0.50),
            "p99_latency": pct(0.99),
            "queue_depth": self.pool.queue_depth(),
            "window_depth": sum(len(w.members)
                                for w in self.windows.values()),
            "gpus": self.pool.total_capacity,
            "gpus_pending": self.pool.total_pending,
            "gpus_busy": self.pool.total_busy,
            "utilization": (d_busy / d_cap) if d_cap > 0 else 0.0,
            "gpu_seconds": self.pool.gpu_seconds,
            "gpu_cost": self.pool.weighted_gpu_seconds,
            "t_lim": self._t_lim_now,
            "preempted_gpus": self.pool.reclaimed_total,
            "killed_jobs": self.pool.killed_total,
            "rejected": self.n_rejected,
            "degraded": self.n_degraded,
            "replans": self.n_replans,
            "per_class": {name: {"gpus": pl.capacity, "busy": pl.busy,
                                 "queue": pl.queue_len()}
                          for name, pl in self.pool.pools.items()},
            # tightest open deadline: what the EDF dispatcher and a
            # pressure-aware SLA controller watch
            "min_slack": self.tracker.min_slack(t),
        })
        if self._active():
            self._push(t + self.cfg.metrics_interval_s, EVT_METRICS)


def _make_arrival_blocks(cfg: SimConfig):
    """v2 arrival stream: the same thinned processes as
    ``_make_arrivals``, drawn in numpy blocks (telemetry.*_arrival_blocks
    — NOT stream-identical to the scalar generators for the same seed;
    see docs/sim_core_v2.md)."""
    if cfg.process == "poisson":
        return poisson_arrival_blocks(cfg.rate, cfg.duration, seed=cfg.seed,
                                      max_rate=cfg.max_rate)
    if cfg.process == "bursty":
        return bursty_arrival_blocks(cfg.rate, cfg.duration, seed=cfg.seed)
    if cfg.process == "diurnal":
        return diurnal_arrival_blocks(cfg.rate, cfg.duration, seed=cfg.seed,
                                      period_s=cfg.diurnal_period_s)
    raise ValueError(f"unknown arrival process {cfg.process!r}")


class FleetSimulatorV2(FleetSimulator):
    """The throughput core (``SimConfig.core="v2"`` — docs/sim_core_v2.md).

    Same handlers, planner, pool, windows, autoscaler, preemption and
    telemetry as v1; what changes is the machinery around them:

    * arrivals come from block-vectorized generators and are bulk-pushed
      into the event queue (v2-specific rng consumption order);
    * the event queue is a bucketed ``EventWheel`` — exact order across
      buckets, FIFO within one — instead of a totally ordered heap;
    * the plan cache is pre-warmed with ONE vectorized
      ``Planner.plan_cohort`` pass over the whole fleet (entries
      bit-identical to the scalar solve, so decision traces still pass
      ``replay.verify_decisions``);
    * streaming stats fill round-robin shards merged via
      ``StreamingLatencyStats.merge`` at the end of the run.

    v2 pins its own golden baseline; v1 stays the oracle via the
    aggregate-tolerance property tests in tests/test_sim_core_v2.py.
    """

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        width = cfg.v2_bucket_s
        if width is None:
            # aim for a handful of events per bucket (~3.5 events per
            # arrival), capped so low-rate runs keep sub-second order
            width = min(0.25, 4.0 / cfg.rate) if cfg.rate > 0 else 0.25
        self._wheel = EventWheel(width)
        self._arrival_blocks = _make_arrival_blocks(cfg)
        self._pending_arrivals = 0
        self._arrivals_left = True
        # one vectorized solve for the whole fleet: every per-arrival
        # plan_profile below is then a pure cache hit
        if self.planner.cache is not None:
            self.planner.plan_cohort(self.fleet)
        self._shards: Optional[List[StreamingLatencyStats]] = None
        self._shard_i = 0
        if self.stream is not None:
            self._shards = [StreamingLatencyStats()
                            for _ in range(max(1, cfg.v2_stream_shards))]

    # -- event plumbing (wheel instead of heap) ----------------------------
    def _push(self, t: float, kind: int, payload=None) -> None:
        self._wheel.push(t, kind, payload)

    def _active(self) -> bool:
        return (self._pending_arrivals > 0 or self._arrivals_left
                or self.tracker.in_flight() > 0)

    def _refill_arrivals(self) -> None:
        """Bulk-push the next non-empty arrival block (tolist(): native
        floats keep every downstream timestamp off numpy scalars)."""
        for blk in self._arrival_blocks:
            if len(blk):
                self._pending_arrivals = len(blk)
                self._wheel.push_times(blk.tolist(), EVT_ARRIVAL)
                return
        self._arrivals_left = False

    def _schedule_next_arrival(self) -> None:
        n = self._pending_arrivals - 1
        self._pending_arrivals = n
        if n == 0 and self._arrivals_left:
            self._refill_arrivals()

    def _on_job_done(self, t: float, job: _Job) -> None:
        # v1's handler with its inlined heap pushes routed to the wheel
        if job.killed:
            return
        qw = job.started - job.submitted
        n_total = self.p.n_total
        k_decode = self.p.k_decode
        push = self._wheel.push
        mob = self._mobility
        for m in job.members:
            m.queue_wait += qw
            prof = m.profile
            r_dev = prof.r_dev
            if mob is None:
                rtt = prof.rtt
            else:
                # live link at ship time (see the v1 handler)
                rtt = mob.ship_rtt(prof.device_id, t, prof.rtt)
                m.where = None
            # wire-format ship delta (see the v1 handler)
            wire_dt = m.assignment.t_network - prof.rtt
            if wire_dt != 0.0:
                rtt += wire_dt
            done = (t + rtt
                    + (n_total - m.assignment.n_final - m.n_credit)
                    / r_dev
                    + k_decode / r_dev)
            push(done, EVT_COMPLETE, m)
        for nxt, finish in self.pool.job_done(t, job):
            push(finish, EVT_JOB_DONE, nxt)

    def _on_complete(self, t: float, req: SimRequest) -> None:
        shards = self._shards
        if shards is None:                 # exact_stats: v1 record path
            super()._on_complete(t, req)
            return
        if self._mobility is not None:
            live = self._session_live.get(req.profile.device_id)
            if live is not None:
                live.pop(req.request_id, None)
        self.tracker.close(req.request_id, t)
        latency = t - req.arrival
        i = self._shard_i
        shards[i].add(latency, req.batched)
        self._shard_i = (i + 1) % len(shards)
        self._recent_lat.append(latency)

    # -- vectorized fast lane (docs/sim_core_v2.md) ------------------------
    def _fast_blockers(self) -> List[str]:
        """Config options the chunked fast lane does NOT implement.  The
        fast lane covers the modal throughput config: FIFO dispatch on a
        single GPU class, streaming stats, no decision trace, no
        preemption, no shedding, no adaptive SLA, no mobility, auto
        bucket sizing.  Anything listed here falls back to the generic
        wheel loop (same v2 semantics, event-at-a-time) — loudly:
        ``FleetSimResult.fast_lane_blockers`` records this list, and
        ``v2_fast="require"`` raises on it, so no option is ever
        silently ignored."""
        cfg = self.cfg
        blockers = []
        if self._trace is not None:
            blockers.append("trace_out")
        if self.stream is None:
            blockers.append("exact_stats")
        if self._preempting:
            blockers.append("preemption")
        if cfg.dispatch != "fifo":
            blockers.append(f"dispatch={cfg.dispatch}")
        if self.pool._single_pool is None:
            blockers.append("multi-class capacity")
        if self.planner.shed_policy is not None:
            blockers.append("shedding")
        if self.sla_ctl is not None:
            blockers.append("adaptive_sla")
        if cfg.sampling not in ("cycle", "uniform"):
            blockers.append(f"sampling={cfg.sampling}")
        if self._mobility is not None:
            blockers.append("mobility")
        if self.planner._wire_candidates:
            # the fast lane inlines the device tail with the raw profile
            # rtt; active wire selection shifts the ship time per format,
            # so it takes the wheel (plan_cohort's scalar fallback keeps
            # decisions identical to v1)
            blockers.append("wire")
        if cfg.v2_bucket_s is not None:
            # explicit bucket sizing asks for the wheel; the fast lane
            # has no wheel and would silently ignore it
            blockers.append("v2_bucket_s")
        return blockers

    def _fast_eligible(self) -> bool:
        return not self._fast_blockers()

    def _run_fast(self) -> FleetSimResult:
        """Cohort-vectorized main loop.

        Arrivals are consumed in fixed time chunks instead of one event
        at a time.  Per-profile plan values come from ONE vectorized
        ``Planner._solve_cohort`` pass (the same arrays behind
        ``plan_cohort``); the per-arrival work is then the admission
        verdict (``deny_slack > queue_delay_hint`` — exactly
        ``BatchingAdmission.decide_from``'s branch), window bookkeeping
        and the FIFO pool, which is modeled by the same algorithm as
        ``GpuPool`` (explicit queue; jobs start when a server frees or
        capacity arrives), so start times match v1's event loop given
        the same submit sequence and capacity timeline.

        Chunk-granular approximations (all bounded by the chunk width,
        documented in docs/sim_core_v2.md): window timeout flushes,
        autoscale/metrics tick times, demand-window expiry, and the
        freshness of the queue-delay hint between pool settles.
        """
        cfg = self.cfg
        p = self.p
        fleet = self.fleet
        F = len(fleet)
        planner = self.planner
        entries = planner._solve_cohort(fleet)

        t_lim = p.t_lim
        n_total = p.n_total
        k_decode = p.k_decode
        batch_size = cfg.batch_size
        window_s = cfg.window_s
        c_batch_of = planner.c_batch_of
        cb_full = (c_batch_of(batch_size)
                   if self.admission is not None else 1.0)

        # per-fleet-index plan arrays (plain lists: the hot loop below
        # does scalar lookups, not numpy gathers)
        nf_l = [e.asg.n_final for e in entries]
        deny_l = [e.deny_slack for e in entries]    # -inf: never batch
        tail_l = [pr.rtt + (n_total - nf_l[i]) / pr.r_dev
                  + k_decode / pr.r_dev
                  for i, pr in enumerate(fleet)]    # post-cloud tail
        local_l = [e2e_latency(0, pr.r_dev, p, pr.rtt, c_batch=1.0)
                   for pr in fleet]                 # device-only e2e

        # chunk width: ~256 arrivals per chunk, capped so window
        # timeouts and the recurring timers keep sub-chunk fidelity
        q = 256.0 / cfg.rate if cfg.rate > 0 else 1.0
        if self.admission is not None:
            q = min(q, window_s / 4.0)
        if cfg.autoscale:
            q = min(q, cfg.autoscale_interval_s)
        q = max(min(q, cfg.metrics_interval_s, 0.05 * t_lim), 1e-3)
        inv_q = 1.0 / q

        # -- single-class FIFO pool state (GpuPool's algorithm on plain
        # floats: `ends` is a heap of busy servers' job-end times, the
        # queue holds (service, members) in submission order) --
        pl = self.pool._single_pool
        cls = pl.gpu_class
        cls_name = cls.name if cls is not None else "gpu"
        cls_rate = cls.r_cloud if cls is not None else p.r_cloud
        weight = pl.cost_weight
        cap = pl.capacity
        min_gpus = pl.min_gpus
        pending = 0
        peak = cap
        released_total = 0
        ends: List[float] = []
        queue: deque = deque()
        queued_service = 0.0
        committed = 0.0                 # gpu-seconds, charged at start
        cap_int = 0.0
        last_cap_t = 0.0
        adds: deque = deque()           # scheduled (t_add, k) capacity

        # in-flight member completions, bucketed by completion chunk:
        # chunk_idx -> [(done, latency, batched, deadline), ...].  A
        # chunk's bucket drains wholesale at the first boundary past it
        # (stats are order-insensitive aggregates, so no heap is
        # needed; counts are exact at chunk boundaries)
        comp_buckets: Dict[int, List[Tuple[float, float, bool, float]]] = {}
        comp_n = 0
        drain_ci = 0
        windows: Dict[int, list] = {}   # n_final -> [flush_at, members]
        demand: deque = deque()         # (t_last, {n_final: count})
        wg_counts: Dict[int, int] = {}

        shards = self._shards
        n_shards = len(shards)
        shard_i = 0
        n_arr = 0
        n_jobs = 0
        n_ev = 0
        completed_n = 0
        violations_n = 0
        last_t = 0.0
        heappush = heapq.heappush
        heappop = heapq.heappop

        def start_job(start: float, service: float, members) -> None:
            nonlocal committed, comp_n
            committed += service
            end = start + service
            heappush(ends, end)
            b01 = len(members) >= 2
            comp_n += len(members)
            for ta, ix in members:
                done = end + tail_l[ix]
                ci = int(done * inv_q)
                b = comp_buckets.get(ci)
                if b is None:
                    comp_buckets[ci] = [(done, done - ta, b01, ta + t_lim)]
                else:
                    b.append((done, done - ta, b01, ta + t_lim))

        def settle(now: float) -> None:
            # servers whose job ended by `now` free up; FIFO queue
            # drains onto them at the end times (== v1's JOB_DONE drain)
            nonlocal queued_service
            while ends and ends[0] <= now:
                e = heappop(ends)
                if queue:
                    service, members = queue.popleft()
                    queued_service -= service
                    start_job(e, service, members)

        def dispatch(now: float, members) -> None:
            nonlocal queued_service, n_jobs
            n_jobs += 1
            b = len(members)
            n = nf_l[members[0][1]]
            cb = (cb_full if b == batch_size
                  else 1.0 if b == 1 else c_batch_of(b))
            service = n * cb / cls_rate
            settle(now)
            if len(ends) < cap:
                start_job(now, service, members)
            else:
                queue.append((service, members))
                queued_service += service

        def apply_adds(upto: float) -> None:
            nonlocal cap, pending, cap_int, last_cap_t, peak, n_ev
            nonlocal queued_service, last_t
            while adds and adds[0][0] <= upto:
                ta, k = adds.popleft()
                settle(ta)
                cap_int += cap * (ta - last_cap_t)
                last_cap_t = ta
                cap += k
                pending -= k
                if cap > peak:
                    peak = cap
                if ta > last_t:
                    last_t = ta
                n_ev += 1
                while queue and len(ends) < cap:
                    service, members = queue.popleft()
                    queued_service -= service
                    start_job(ta, service, members)

        def drain_completions(upto: float) -> None:
            # bucket-granular: drains every bucket wholly below `upto`
            # (one shard add_many per bucket instead of per-member heap
            # pops — counts/violations are exact, stats ingest order is
            # per-bucket FIFO rather than completion-sorted)
            nonlocal completed_n, violations_n, shard_i, last_t
            nonlocal comp_n, drain_ci
            if upto == math.inf:
                hi = max(comp_buckets) + 1 if comp_buckets else drain_ci
            else:
                hi = int(upto * inv_q)
            recent = self._recent_lat
            while drain_ci < hi:
                b = comp_buckets.pop(drain_ci, None)
                drain_ci += 1
                if b is None:
                    continue
                lats = []
                nb = 0
                viol = 0
                mx = 0.0
                for done, lat, b01, dl in b:
                    lats.append(lat)
                    if b01:
                        nb += 1
                    if done > dl + 1e-9:    # DeadlineTracker.close
                        viol += 1
                    if done > mx:
                        mx = done
                completed_n += len(b)
                comp_n -= len(b)
                violations_n += viol
                shards[shard_i].add_many(lats, nb)
                shard_i = (shard_i + 1) % n_shards
                recent.extend(lats)
                if mx > last_t:
                    last_t = mx

        def do_autoscale(now: float) -> None:
            nonlocal cap, pending, cap_int, last_cap_t, released_total
            nonlocal n_ev
            n_ev += 1
            settle(now)
            expire = now - cfg.horizon_s
            while demand and demand[0][0] < expire:
                _, counts = demand.popleft()
                for n, c in counts.items():
                    wg_counts[n] -= c
            plan = plan_capacity_targets(
                cfg.policy, wg_counts, planner.p, self.capacity_spec,
                current={cls_name: cap},
                horizon_s=min(cfg.horizon_s, now),
                headroom=cfg.headroom,
                release_threshold=cfg.release_threshold,
                # single class (guarded by _fast_eligible): the
                # deadline floors never consume the demand profiles
                demands=iter(()),
                demand_c_batch=cb_full,
                rate_discounts=None)
            target = plan.targets.get(cls_name, cap)
            provisioned = cap + pending
            if target > provisioned:
                k = target - provisioned
                pending += k
                adds.append((now + cfg.provision_delay_s, k))
            elif plan.release_gpus and target < cap:
                tgt = max(target, len(ends), min_gpus)  # release_to
                rel = cap - tgt
                if rel > 0:
                    cap_int += cap * (now - last_cap_t)
                    last_cap_t = now
                    cap = tgt
                    released_total += rel

        def do_metrics(now: float) -> None:
            nonlocal n_ev
            n_ev += 1
            settle(now)
            busy_int = committed - sum(e - now for e in ends)
            cap_int_now = cap_int + cap * (now - last_cap_t)
            d_busy = busy_int - self._last_busy_int
            d_cap = cap_int_now - self._last_cap_int
            self._last_busy_int = busy_int
            self._last_cap_int = cap_int_now
            lats = self._recent_lat
            self._recent_lat = []
            win_depth = sum(len(w[1]) for w in windows.values())
            in_flight = (comp_n + win_depth
                         + sum(len(m) for _, m in queue))
            ms = math.inf
            for b in comp_buckets.values():
                for _, _, _, dl in b:
                    if dl < ms:
                        ms = dl
            for _, members in queue:
                for ta, _ in members:
                    if ta + t_lim < ms:
                        ms = ta + t_lim
            for w in windows.values():
                for ta, _ in w[1]:
                    if ta + t_lim < ms:
                        ms = ta + t_lim
            self.timeseries.append({
                "t": now,
                "arrivals": n_arr,
                "completed": completed_n,
                "in_flight": in_flight,
                "violations": violations_n,
                "p50_latency": (latency_percentile(lats, 50.0)
                                if lats else None),
                "p99_latency": (latency_percentile(lats, 99.0)
                                if lats else None),
                "queue_depth": len(queue),
                "window_depth": win_depth,
                "gpus": cap,
                "gpus_pending": pending,
                "gpus_busy": len(ends),
                "utilization": (d_busy / d_cap) if d_cap > 0 else 0.0,
                "gpu_seconds": committed,
                "gpu_cost": committed * weight,
                "t_lim": t_lim,
                "preempted_gpus": 0,
                "killed_jobs": 0,
                "rejected": 0,
                "degraded": 0,
                "replans": 0,
                "per_class": {cls_name: {"gpus": cap, "busy": len(ends),
                                         "queue": len(queue)}},
                "min_slack": (ms - now) if ms < math.inf else None,
            })

        # -- chunked main loop --------------------------------------------
        next_autoscale = (cfg.autoscale_interval_s if cfg.autoscale
                          else math.inf)
        next_metrics = cfg.metrics_interval_s
        blocks = self._arrival_blocks
        buf: Optional[List[float]] = None
        idx_buf: Optional[List[int]] = None
        bi = 0
        uniform = cfg.sampling == "uniform"
        # v2-specific sampling stream for mode "uniform": same seed
        # family as v1's sampler, drawn in blocks (rng-stream caveat)
        samp_rng = (np.random.default_rng(cfg.seed + 1) if uniform
                    else None)
        ord_ = 0
        T1 = q
        while True:
            if buf is not None and bi >= len(buf):
                buf = None
            if buf is None:
                for blk in blocks:
                    if len(blk):
                        buf = blk.tolist()
                        if uniform:
                            idx_buf = samp_rng.integers(
                                0, F, size=len(buf)).tolist()
                        bi = 0
                        break
            if (buf is None and not comp_buckets and not windows
                    and not queue):
                break
            apply_adds(T1)
            settle(T1 - q)
            drain_completions(T1 - q)
            while True:
                if next_autoscale <= next_metrics:
                    tx = next_autoscale
                    if tx >= T1:
                        break
                    do_autoscale(tx)
                    next_autoscale += cfg.autoscale_interval_s
                else:
                    tx = next_metrics
                    if tx >= T1:
                        break
                    do_metrics(tx)
                    next_metrics += cfg.metrics_interval_s
                if tx > last_t:
                    last_t = tx
            cc: Dict[int, int] = {}
            t_a = 0.0
            while buf is not None:
                t_a = buf[bi]
                if t_a >= T1:
                    break
                ix = idx_buf[bi] if uniform else ord_
                bi += 1
                if not uniform:
                    ord_ += 1
                    if ord_ == F:
                        ord_ = 0
                n_arr += 1
                n = nf_l[ix]
                cc[n] = cc.get(n, 0) + 1
                if n <= 0:
                    # device-only: completes at the local closed form
                    lat = local_l[ix]
                    done = t_a + lat
                    ci = int(done * inv_q)
                    b = comp_buckets.get(ci)
                    if b is None:
                        comp_buckets[ci] = [(done, lat, False,
                                             t_a + t_lim)]
                    else:
                        b.append((done, lat, False, t_a + t_lim))
                    comp_n += 1
                    if bi >= len(buf):
                        break
                    continue
                settle(t_a)
                qd = (queued_service / (cap if cap > 0 else 1)
                      if queue else 0.0)
                if deny_l[ix] > qd:     # decide_from: max_wait > 0
                    w = windows.get(n)
                    mw = deny_l[ix] - qd
                    stale = t_a + (window_s if window_s < mw else mw)
                    if w is None:
                        windows[n] = [stale, [(t_a, ix)]]
                        n_ev += 1
                    else:
                        mem = w[1]
                        mem.append((t_a, ix))
                        if len(mem) >= batch_size:
                            del windows[n]
                            dispatch(t_a, mem)
                        elif stale < w[0]:
                            w[0] = stale
                else:
                    dispatch(t_a, ((t_a, ix),))
                if bi >= len(buf):
                    break
            if cc:
                demand.append((t_a, cc))
                for n, c in cc.items():
                    wg_counts[n] = wg_counts.get(n, 0) + c
            if windows:
                expired = [n for n, w in windows.items() if w[0] < T1]
                for n in expired:
                    w = windows.pop(n)
                    n_ev += 1
                    dispatch(w[0], w[1])
            T1 += q
        # trailing scheduled capacity (v1 drains every EVT_CAPACITY)
        apply_adds(math.inf)
        settle(last_t)
        drain_completions(math.inf)
        cap_int += cap * (last_t - last_cap_t)

        # -- write-back: the real pool/tracker objects feed
        # _build_result and per_class_stats --
        self.n_arrivals = n_arr
        self.n_events = n_ev + n_arr + n_jobs + completed_n
        self.tracker.completed = completed_n
        self.tracker.violations = violations_n
        # one decision per arrival, served from the cohort solve (the
        # cache-hit path's work, vectorized)
        planner.plan_calls += n_arr
        if planner.cache is not None:
            planner.cache.hits += n_arr
        pl.capacity = cap
        pl.pending = pending
        pl.peak_capacity = peak
        pl.released_total = released_total
        pl.gpu_seconds = committed
        pl.weighted_gpu_seconds = committed * weight
        pl.busy = 0
        pl.queued_service = 0.0
        pl._busy_integral = committed
        pl._cap_integral = cap_int
        pl._last_t = last_t
        self.pool.peak_capacity = peak
        self.stream = StreamingLatencyStats.merged(shards)
        return self._build_result(last_t)

    # -- main loop ---------------------------------------------------------
    def run(self) -> FleetSimResult:
        cfg = self.cfg
        blockers = self._fast_blockers()
        if cfg.v2_fast == "require" and blockers:
            raise ValueError(
                f"v2_fast='require' but the fast lane cannot run this "
                f"config; blocked by: {', '.join(blockers)}")
        if cfg.v2_fast != "off" and self._fast_eligible():
            self._fast_lane = True
            self._fast_blockers_rec = []
            if cfg.processes > 1 or cfg.shard_cohorts is not None:
                # cohort-sharded BSP mode (docs/sim_core_v2.md,
                # "Multiprocess sharding"); lazy import avoids a cycle
                from repro_torch.serving.shard_sim import run_sharded
                return run_sharded(self)
            return self._run_fast()
        # loud fallback: the wheel path runs, and the result names why
        self._fast_lane = False
        self._fast_blockers_rec = blockers if blockers else ["v2_fast=off"]
        self._refill_arrivals()
        self._arm_recurring(cfg)

        handlers = (self._on_capacity, self._on_job_done,
                    self._on_arrival, self._on_window, self._on_autoscale,
                    self._on_complete, self._on_metrics, self._on_preempt,
                    self._on_net_shift)
        wheel = self._wheel
        buckets = wheel.buckets
        order = wheel.order
        pop = heapq.heappop
        t = 0.0
        n_ev = 0
        while order:
            idx = pop(order)
            bucket = buckets[idx]
            i = 0
            # the bucket may GROW while draining: handlers only schedule
            # at t' >= t, so same-bucket pushes append to this list and
            # run this pass (wheel FIFO semantics); future-bucket pushes
            # create/extend later buckets
            while i < len(bucket):
                t, kind, payload = bucket[i]
                i += 1
                handlers[kind](t, payload)
            n_ev += i
            del buckets[idx]
        self.n_events = n_ev
        if self._trace is not None:
            self._trace.close()
        if self._shards is not None:
            self.stream = StreamingLatencyStats.merged(self._shards)
        return self._build_result(t)


def run_fleet_sim(cfg: SimConfig) -> FleetSimResult:
    """Convenience wrapper: build + run one simulation on the core the
    config selects (``SimConfig.core``)."""
    if cfg.core == "v2":
        return FleetSimulatorV2(cfg).run()
    if cfg.core != "v1":
        raise ValueError(f"unknown simulation core {cfg.core!r}; "
                         f"expected 'v1' or 'v2'")
    return FleetSimulator(cfg).run()
