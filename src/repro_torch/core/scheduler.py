"""The paper's scheduler (§4.3–§4.5): decide per request how much of the
job the cloud runs, quantized to a step grid so requests form batchable
groups, with optional intelligent batching.

Four policies, matching paper Table 4:
  * AllCloudScheduler          — n_cloud = n_total for everyone
  * ConstantIterationScheduler — one n for all devices, sized for the
                                 slowest (the paper's "45 of 50")
  * VariableIterationScheduler — per-device solve + step quantization
  * IntelligentBatchingScheduler — variable + §4.4 batching admission

Each returns per-request ``Assignment``s; ``summarize`` produces the cloud
GPU time (Table 4), latency distribution (Figs 12/13/15), and group
workloads w_group (§4.5) used by the GPU resource allocator.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.cost_model import (
    BatchModel,
    CostParams,
    batchable,
    c_batch_at,
    cloud_gpu_time,
    e2e_latency,
    quantize_step,
    solve_n_cloud,
    solve_n_cloud_cached,
)
from repro_torch.core.telemetry import DeviceProfile


@dataclasses.dataclass
class Assignment:
    device_id: str
    r_dev: float
    t_network: float
    n_exact: float            # real-valued solver output
    n_final: int              # after step quantization
    latency: float            # predicted E2E latency at n_final
    feasible: bool            # latency <= t_lim
    batched: bool = False     # set by intelligent batching
    batch_factor: float = 1.0 # c_batch / batch_size applied to GPU time

    def gpu_time(self, p: CostParams) -> float:
        return cloud_gpu_time(self.n_final, p, self.batch_factor)


@dataclasses.dataclass
class ScheduleSummary:
    name: str
    assignments: List[Assignment]
    total_gpu_time: float
    latencies: List[float]
    violations: int
    group_workloads: Dict[int, float]     # n_final -> w_group (§4.5)
    batched_fraction: float = 0.0

    def p99_latency(self) -> float:
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


class SchedulerBase:
    """``assign_one`` is the ONLINE surface: one request in, one
    ``Assignment`` out, no fleet snapshot required — this is what the
    event-driven fleet simulator calls per arrival.  ``schedule`` is the
    batch surface over a snapshot (the static Table-4 path); only the
    intelligent-batching scheduler adds snapshot-wide post-processing
    there, and its online equivalent lives in ``core.admission``.
    """

    name = "base"
    #: True when requests within a group may be batched (§4.4) — the
    #: simulator only opens batching windows for such schedulers.
    supports_batching = False

    def __init__(self, params: CostParams):
        self.p = params

    def assign_one(self, prof: DeviceProfile) -> Assignment:
        raise NotImplementedError

    def group_key(self, a: Assignment) -> int:
        """Batching-group identity (§4.4): requests sharing n_final share
        a compiled executable and may run in one batch."""
        return a.n_final

    def schedule(self, fleet: Sequence[DeviceProfile]) -> List[Assignment]:
        return [self.assign_one(d) for d in fleet]

    def summarize(self, fleet: Sequence[DeviceProfile]) -> ScheduleSummary:
        asg = self.schedule(fleet)
        return summarize(self.name, asg, self.p)


def _mk_assignment(prof: DeviceProfile, n_exact: float, n_final: int,
                   p: CostParams) -> Assignment:
    lat = e2e_latency(n_final, prof.r_dev, p, prof.rtt, c_batch=1.0)
    return Assignment(
        device_id=prof.device_id, r_dev=prof.r_dev, t_network=prof.rtt,
        n_exact=n_exact, n_final=n_final, latency=lat,
        feasible=lat <= p.t_lim + 1e-9)


class AllCloudScheduler(SchedulerBase):
    name = "all_cloud"

    def assign_one(self, prof: DeviceProfile) -> Assignment:
        return _mk_assignment(prof, float(self.p.n_total), self.p.n_total, self.p)


class ConstantIterationScheduler(SchedulerBase):
    """One iteration count for the whole fleet, sized for the slowest
    device the service targets (paper: 45 of 50 for the 3-sigma fleet)."""
    name = "constant"

    def __init__(self, params: CostParams, worst_r_dev: float,
                 worst_rtt: float = 0.3):
        super().__init__(params)
        n = solve_n_cloud(worst_r_dev, params, worst_rtt, c_batch=1.0)
        self.n_const = quantize_step(n, params.n_step, params.n_total)

    def assign_one(self, prof: DeviceProfile) -> Assignment:
        return _mk_assignment(prof, float(self.n_const), self.n_const, self.p)


class VariableIterationScheduler(SchedulerBase):
    """``solve_c_batch`` is the cloud slowdown the per-request solve
    assumes: 1.0 (default) sizes for a solo run — the Table-4 policy;
    an engine that always executes groups batched passes its measured
    c_batch to size conservatively for the batched rate."""
    name = "variable"

    def __init__(self, params: CostParams, solve_c_batch: float = 1.0):
        super().__init__(params)
        self.solve_c_batch = solve_c_batch

    def assign_one(self, prof: DeviceProfile) -> Assignment:
        # memoized root: a fleet has few distinct (r_dev, rtt) profiles,
        # so repeat requests skip the closed-form re-derivation (the
        # cache key includes self.p — set_t_lim swaps params and misses)
        n = solve_n_cloud_cached(prof.r_dev, self.p, prof.rtt,
                                 c_batch=self.solve_c_batch)
        nf = quantize_step(n, self.p.n_step, self.p.n_total)
        return _mk_assignment(prof, n, nf, self.p)


class IntelligentBatchingScheduler(VariableIterationScheduler):
    """Variable iteration + §4.4: within each n_final group, requests that
    still meet the SLA at the batched rate are paired; each pair costs
    c_batch/batch_size GPU-time per request.  Odd leftovers run alone.

    ``batched`` marks ADMISSION (the request tolerates the batched rate —
    what paper Fig 14 sweeps); the GPU-time discount is only applied when
    batching actually saves accelerator time (c_batch < batch_size),
    otherwise the engine runs requests solo and total time never exceeds
    the plain variable scheduler's.
    """
    name = "variable+batching"
    supports_batching = True

    def __init__(self, params: CostParams, c_batch: float,
                 batch_size: int = 2,
                 batch_model: Optional[BatchModel] = None):
        super().__init__(params)
        # c_batch is measured at batch 2 (paper §5.5); other batch sizes
        # extrapolate through the §4.4 linear micro-model — unless a
        # calibrated BatchModel (fit from real multi-point timings) is
        # given, in which case its fitted slope replaces both
        self.batch_model = batch_model
        if batch_model is not None:
            self.c_batch_measured = batch_model.c_batch_2
            self.c_batch = batch_model.c_batch(batch_size)
        else:
            self.c_batch_measured = c_batch
            self.c_batch = c_batch_at(c_batch, batch_size)
        self.batch_size = batch_size

    def admission(self):
        """Online §4.4 admission policy matching this scheduler's batching
        constants (used by the fleet simulator's batching windows)."""
        from repro_torch.core.admission import BatchingAdmission
        # pass the raw batch-2 measurement: BatchingAdmission applies the
        # same c_batch_at extrapolation (or the shared BatchModel) itself
        return BatchingAdmission(self.p, self.c_batch_measured,
                                 self.batch_size,
                                 batch_model=self.batch_model)

    def schedule(self, fleet: Sequence[DeviceProfile]) -> List[Assignment]:
        asg = super().schedule(fleet)
        saves_time = self.c_batch < self.batch_size
        groups: Dict[int, List[Assignment]] = {}
        for a in asg:
            if a.n_final > 0:
                groups.setdefault(a.n_final, []).append(a)
        for n_final, members in groups.items():
            ok = [a for a in members
                  if batchable(a.n_final, a.r_dev, self.p, a.t_network,
                               self.c_batch)]
            # pair up: batches of `batch_size`, leftovers unbatched
            full = len(ok) // self.batch_size * self.batch_size
            for i, a in enumerate(ok):
                if i < full:
                    a.batched = True
                    if saves_time:
                        a.batch_factor = self.c_batch / self.batch_size
                        a.latency = e2e_latency(a.n_final, a.r_dev, self.p,
                                                a.t_network, self.c_batch)
                        a.feasible = a.latency <= self.p.t_lim + 1e-9
        return asg


def group_workloads(n_finals) -> Dict[int, float]:
    """§4.5 per-group workload w_group = n_task * n_group, aggregated
    from per-request n_final values — shared by the static summary and
    the fleet simulator's sliding-horizon autoscaler."""
    wg: Dict[int, float] = {}
    for n in n_finals:
        wg[n] = wg.get(n, 0.0) + n
    return wg


def summarize(name: str, assignments: List[Assignment],
              p: CostParams) -> ScheduleSummary:
    total = sum(a.gpu_time(p) for a in assignments)
    lats = [a.latency for a in assignments]
    viol = sum(not a.feasible for a in assignments)
    wg = group_workloads(a.n_final for a in assignments)
    frac = (sum(a.batched for a in assignments) / max(1, len(assignments)))
    return ScheduleSummary(
        name=name, assignments=assignments, total_gpu_time=total,
        latencies=lats, violations=viol, group_workloads=wg,
        batched_fraction=frac)


# --------------------------------------------------------------------------
# §4.5: GPU resource allocation from group workloads
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AllocationPlan:
    fractions: Dict[int, float]     # n_final group -> fraction of GPUs
    total_workload: float
    gpus_needed: int
    release_gpus: bool              # total below threshold -> free capacity


def allocate_gpus(summary: ScheduleSummary, p: CostParams, n_gpus: int,
                  horizon_s: float, release_threshold: float = 0.5
                  ) -> AllocationPlan:
    """Proportional allocation by w_group = n_task * n_group (paper §4.5).

    gpus_needed = total iterations / (r_cloud * horizon); when the demand
    falls below ``release_threshold * n_gpus`` the plan flags that GPUs can
    be released to other (production) jobs — the paper's over-subscription
    argument.
    """
    total = sum(summary.group_workloads.values())
    fracs = {g: (w / total if total else 0.0)
             for g, w in summary.group_workloads.items()}
    needed = math.ceil(total / (p.r_cloud * horizon_s)) if total else 0
    return AllocationPlan(
        fractions=fracs, total_workload=total, gpus_needed=needed,
        release_gpus=needed < release_threshold * n_gpus)


# --------------------------------------------------------------------------
# Heterogeneous capacity (core.capacity): class-aware dispatch + §4.5
# per-class allocation
# --------------------------------------------------------------------------
def cheapest_feasible_class(n_final: int, r_dev: float, t_network: float,
                            p: CostParams, capacity,
                            c_batch: float = 1.0,
                            slack_s: float = 0.0):
    """Pick the cheapest GPU class whose rate still meets the request's
    deadline (the heterogeneous dispatch rule).

    ``capacity`` is a ``core.capacity.CloudCapacity``.  Classes are tried
    cheapest-$/GPU-s first; the first whose no-queue latency (plus any
    known ``slack_s`` already spent waiting/queueing) fits inside t_lim
    wins.  When no class is feasible the FASTEST class is returned — the
    least-bad best effort, mirroring ``solve_n_cloud`` saturating at
    n_total.

    This is the pure model-level rule; the fleet simulator's
    ``HeterogeneousDispatcher.route`` is its queue-state-aware sibling
    (per-class queue estimates, zero-capacity exclusion) — keep their
    orderings in sync.
    """
    for cls in capacity.cheapest_first():
        lat = e2e_latency(n_final, r_dev, p, t_network, c_batch=c_batch,
                          r_cloud=cls.r_cloud)
        if lat + slack_s <= p.t_lim + 1e-9:
            return cls
    return capacity.fastest()


@dataclasses.dataclass
class HeteroAllocationPlan:
    """§4.5 plan for a heterogeneous pool: per-class GPU targets
    (scale-spot-first / release-spot-first greedy), plus the scalar plan
    at the reference rate it was derived from."""
    targets: Dict[str, int]         # class name -> target GPU count
    reference: AllocationPlan       # scalar plan at the reference rate
    needed_supply: float            # iterations/s the targets must cover
    floors: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def release_gpus(self) -> bool:
        return self.reference.release_gpus


@functools.lru_cache(maxsize=1 << 16)
def _floor_boundary_idx(n_final: int, r_dev: float, t_network: float,
                        p: CostParams, c_batch: float,
                        eff_rates: tuple) -> int:
    """Index (into the fastest-first class walk) of the SLOWEST class
    whose no-queue latency still meets the SLA for one demand — the
    inner loop of ``deadline_floors``, memoized: the §4.5 re-plan
    re-walks the same few distinct device profiles thousands of times
    per sliding window, and the boundary only depends on the profile,
    the params epoch, and the (discounted) class rates."""
    for i in range(len(eff_rates) - 1, -1, -1):
        lat = e2e_latency(n_final, r_dev, p, t_network, c_batch=c_batch,
                          r_cloud=eff_rates[i])
        if lat <= p.t_lim + 1e-9:
            return i
    return 0                             # infeasible-everywhere: fastest


def deadline_floors(demands, p: CostParams, capacity, horizon_s: float,
                    headroom: float = 1.0,
                    c_batch: float = 1.0,
                    discounts=None) -> Dict[str, int]:
    """Deadline-aware per-class GPU floors (the docs/capacity.md caveat
    fix): demand that only fast classes can serve within ``p.t_lim``
    must be covered by those classes, so blind spot-first scaling cannot
    starve the reserved class when spot is too slow for tight deadlines.

    ``demands`` is an iterable of ``(n_final, r_dev, t_network)`` — the
    same sliding-horizon window the §4.5 re-plan aggregates.
    ``c_batch`` is the slowdown jobs actually run at (pass the batch-b
    slowdown when the policy batches: a batched job holds a slow class
    even longer, which is precisely what saturates the reserved slice).

    ``discounts`` (class name -> ``capacity.preemption_discount``)
    makes the floors preemption-aware: feasibility and pledged supply
    are judged at each class's EFFECTIVE rate, so a spot class under
    heavy reclaim is treated as slower than its nameplate rate and
    tight-deadline demand is pinned on reserved capacity.  Absent/1.0
    entries are bit-exact no-ops.

    Each demand is charged to the SLOWEST class whose no-queue latency
    still meets the SLA (the cheapest-feasible dispatch boundary;
    nothing feasible falls back to the fastest class, mirroring
    ``cheapest_feasible_class``).  Walking classes fastest-first, each
    class's floor covers the cumulative demand that cannot flow to
    anything slower, net of the supply already pledged by faster
    classes.  Demand the SLOWEST class can serve is unconstrained — it
    imposes no floor (aggregate supply is the §4.5 reference plan's
    job), so for a homogeneous capacity every floor is zero and the
    plan is EXACTLY the legacy scalar plan — the golden-trace anchor.
    """
    eff = {c.name: c.r_cloud * (discounts or {}).get(c.name, 1.0)
           for c in capacity}
    classes = sorted(capacity, key=lambda c: (-eff[c.name], c.name))
    floors: Dict[str, int] = {c.name: 0 for c in classes}
    if len(classes) < 2:
        return floors
    # its/s of demand whose feasibility boundary is class i (can run on
    # i or anything faster, but nothing slower)
    need_rate = [0.0] * len(classes)
    eff_rates = tuple(eff[c.name] for c in classes)
    for n_final, r_dev, t_network in demands:
        if n_final <= 0:
            continue
        idx = _floor_boundary_idx(n_final, r_dev, t_network, p, c_batch,
                                  eff_rates)
        need_rate[idx] += n_final / horizon_s * headroom
    need = 0.0
    pledged = 0.0
    for i, c in enumerate(classes[:-1]):     # slowest class: no floor
        need += need_rate[i]
        gap = need - pledged
        floor = min(c.max_count, int(math.ceil(gap / eff[c.name] - 1e-9))) \
            if gap > 1e-12 else 0
        floors[c.name] = max(0, floor)
        pledged += floors[c.name] * eff[c.name]
        # demand a max_count-clamped class cannot cover must NOT spill
        # onto slower classes: they cannot meet its SLA, so pinning
        # them raises cost without reducing violations (the residual is
        # best-effort, handled by dispatch's fastest-class fallback)
        need = min(need, pledged)
    return floors


def allocate_gpus_heterogeneous(summary: ScheduleSummary, p: CostParams,
                                capacity, current: Dict[str, int],
                                horizon_s: float, headroom: float = 1.0,
                                release_threshold: float = 0.5,
                                demands=None,
                                demand_c_batch: float = 1.0,
                                rate_discounts=None
                                ) -> HeteroAllocationPlan:
    """Class-aware §4.5 allocation: size the pool at the reference rate,
    then meet that supply with per-class counts via
    ``CloudCapacity.plan_counts`` (spot scales first, spot releases
    first).

    ``demands`` (optional ``(n_final, r_dev, t_network)`` tuples — the
    demand window behind ``summary.group_workloads``) enables the
    deadline-aware floors: per-class feasibility is considered BEFORE
    choosing which class to scale, so tight-deadline demand pins
    reserved capacity even while spot still has headroom.

    ``rate_discounts`` (class name -> ``capacity.preemption_discount``)
    makes the whole plan preemption-aware: ``plan_counts`` provisions
    extra spot GPUs to cover expected reclaim loss and the deadline
    floors judge spot feasibility at its effective (discounted) rate.

    For a homogeneous capacity this reduces EXACTLY to the scalar path:
    target = clamp(ceil(gpus_needed * headroom), min, max).
    """
    r_ref = capacity.reference_rate()
    p_ref = dataclasses.replace(p, r_cloud=r_ref)
    n_current = sum(current.values())
    ref_plan = allocate_gpus(summary, p_ref, n_gpus=n_current,
                             horizon_s=horizon_s,
                             release_threshold=release_threshold)
    want_ref = math.ceil(ref_plan.gpus_needed * headroom)
    needed_supply = want_ref * r_ref
    floors = (deadline_floors(demands, p, capacity, horizon_s,
                              headroom=headroom, c_batch=demand_c_batch,
                              discounts=rate_discounts)
              if demands is not None else {})
    targets = capacity.plan_counts(needed_supply, current, floors=floors,
                                   discounts=rate_discounts)
    return HeteroAllocationPlan(targets=targets, reference=ref_plan,
                                needed_supply=needed_supply, floors=floors)


def fold_demand_counts(counts_iterable) -> Dict[int, int]:
    """Fold per-shard ``{n_final: count}`` demand dicts into one fleet-wide
    dict (exact integer sums).  The multiprocess shard coordinator folds
    each barrier's per-cohort demand reports through this before
    re-planning capacity; iterate shards in a deterministic (cohort-id)
    order so every fold is reproducible."""
    total: Dict[int, int] = {}
    for counts in counts_iterable:
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
    return total


def plan_capacity_targets(policy: str, wg_counts: Dict[int, int],
                          p: CostParams, capacity,
                          current: Dict[str, int], horizon_s: float,
                          headroom: float = 1.0,
                          release_threshold: float = 0.5,
                          demands=None, demand_c_batch: float = 1.0,
                          rate_discounts=None) -> HeteroAllocationPlan:
    """The §4.5 re-plan from a demand-window count dict: build the
    ``w_group = n * count`` workloads (integer-exact — bitwise equal to
    rescanning the window) and run ``allocate_gpus_heterogeneous``.

    This is the ONE capacity entry point shared by the v1 event loop,
    the v2 fast lane, and the multiprocess shard coordinator, so the
    three autoscaler call sites cannot drift apart."""
    wg = {n: float(n * c) for n, c in wg_counts.items() if c > 0}
    summary = ScheduleSummary(
        name=policy, assignments=[], total_gpu_time=0.0,
        latencies=[], violations=0, group_workloads=wg)
    return allocate_gpus_heterogeneous(
        summary, p, capacity, current=current, horizon_s=horizon_s,
        headroom=headroom, release_threshold=release_threshold,
        demands=demands, demand_c_batch=demand_c_batch,
        rate_discounts=rate_discounts)
