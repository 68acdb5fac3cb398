"""Heterogeneous cloud capacity: GPU classes and the pool-level model.

The paper's §4.5 allocator assumes one homogeneous GPU class — a single
scalar ``r_cloud``.  Its own over-subscription argument (releasing GPUs
back to production jobs) only gets interesting when the pool mixes GPU
generations and spot capacity, so this module makes capacity a
first-class abstraction:

* ``GpuClass`` — one homogeneous slice of the pool: a name, a diffusion
  rate ``r_cloud`` (iterations/s per GPU), an initial ``count``, whether
  it is ``preemptible`` (spot), a relative ``cost_weight`` ($/GPU-s),
  and scaling bounds.
* ``CloudCapacity`` — an immutable set of classes.  Its
  ``reference_rate()`` (count-weighted mean) is what the closed-form
  solves in ``core.cost_model`` use as the scalar ``CostParams.r_cloud``,
  so every existing single-rate surface keeps working; class-aware
  callers (the fleet simulator's dispatcher, the §4.5 per-class
  autoscaler) iterate the classes themselves.

Scaling policy (paper §4.5, extended): **scale spot first, release spot
first** — growth lands on preemptible capacity (cheap, and the first to
hand back), release drains preemptible capacity before touching the
reserved base.  ``plan_counts`` implements that greedy order and reduces
exactly to the scalar plan when there is a single class.

Calibration: ``CloudCapacity.from_roofline`` consumes the per-hardware
``r_cloud_est`` records that ``roofline.analysis`` / ``launch.dryrun``
emit, replacing hand calibration of per-class rates.

Preemption (docs/preemption.md): preemptible capacity can be reclaimed
mid-job by the provider.  ``preemption_discount`` models the resulting
effective-throughput loss per spot GPU; ``supply``/``plan_counts``
accept per-class ``discounts`` so the §4.5 plan provisions extra spot
GPUs to cover expected reclaim — the preemption-aware headroom.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GpuClass:
    """One homogeneous slice of the cloud pool."""
    name: str
    r_cloud: float              # iterations/s per GPU of this class
    count: int                  # initially provisioned GPUs
    preemptible: bool = False   # spot capacity: first to scale, first to go
    cost_weight: float = 1.0    # relative $/GPU-second (reference class = 1)
    min_count: int = 0
    max_count: int = 1024

    def __post_init__(self):
        if self.r_cloud <= 0:
            raise ValueError(f"class {self.name!r}: r_cloud must be > 0")
        if not (0 <= self.min_count <= self.max_count):
            raise ValueError(f"class {self.name!r}: need "
                             "0 <= min_count <= max_count")
        if not (0 <= self.count <= self.max_count):
            # count < min_count is allowed: pools clamp their capacity to
            # max(count, min_count) at construction (legacy behavior)
            raise ValueError(f"class {self.name!r}: count {self.count} "
                             f"outside [0, {self.max_count}]")
        if self.cost_weight <= 0:
            raise ValueError(f"class {self.name!r}: cost_weight must be > 0")


@dataclasses.dataclass(frozen=True)
class CloudCapacity:
    """An immutable set of GPU classes making up the cloud pool."""
    classes: Tuple[GpuClass, ...]

    def __post_init__(self):
        if not self.classes:
            raise ValueError("CloudCapacity needs at least one GpuClass")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate GpuClass names: {names}")

    # -- container surface -------------------------------------------------
    def __iter__(self) -> Iterator[GpuClass]:
        return iter(self.classes)

    def __len__(self) -> int:
        return len(self.classes)

    def __getitem__(self, name: str) -> GpuClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def homogeneous(self) -> bool:
        return len(self.classes) == 1

    # -- derived scalars ---------------------------------------------------
    def reference_rate(self) -> float:
        """Count-weighted mean rate: the scalar ``r_cloud`` the closed-form
        solves see.  Equals the class rate for a homogeneous pool."""
        if len(self.classes) == 1:
            return self.classes[0].r_cloud     # exact, no float round-trip
        total = sum(c.count for c in self.classes)
        if total == 0:
            # nothing provisioned yet: fall back to the unweighted mean
            return sum(c.r_cloud for c in self.classes) / len(self.classes)
        return sum(c.r_cloud * c.count for c in self.classes) / total

    def total_count(self) -> int:
        return sum(c.count for c in self.classes)

    def supply(self, counts: Optional[Mapping[str, int]] = None,
               discounts: Optional[Mapping[str, float]] = None) -> float:
        """Aggregate iteration throughput (its/s) at ``counts`` (default:
        the provisioned counts).  ``discounts`` multiplies each class's
        rate by an effective-throughput factor (``preemption_discount``
        for spot classes under reclaim); absent/1.0 entries leave the
        rate bit-exact."""
        if counts is None:
            counts = {c.name: c.count for c in self.classes}
        if discounts is None:
            return sum(c.r_cloud * counts.get(c.name, 0)
                       for c in self.classes)
        return sum(c.r_cloud * discounts.get(c.name, 1.0)
                   * counts.get(c.name, 0) for c in self.classes)

    # -- orderings ---------------------------------------------------------
    def cheapest_first(self) -> List[GpuClass]:
        """Dispatch preference: cheapest $/GPU-s first; at equal cost the
        faster class (finishing earlier never hurts a deadline)."""
        return sorted(self.classes,
                      key=lambda c: (c.cost_weight, -c.r_cloud, c.name))

    def fastest(self) -> GpuClass:
        return max(self.classes, key=lambda c: (c.r_cloud, c.name))

    def scale_order(self) -> List[GpuClass]:
        """Growth preference: spot first (cheap + returned first), then by
        ascending cost."""
        return sorted(self.classes,
                      key=lambda c: (not c.preemptible, c.cost_weight,
                                     c.name))

    def release_order(self) -> List[GpuClass]:
        """Release preference: spot capacity drains before the reserved
        base (the paper's over-subscription story, per class)."""
        return self.scale_order()

    # -- §4.5 per-class planning -------------------------------------------
    def plan_counts(self, needed_supply: float,
                    current: Mapping[str, int],
                    floors: Optional[Mapping[str, int]] = None,
                    discounts: Optional[Mapping[str, float]] = None
                    ) -> Dict[str, int]:
        """Per-class GPU targets meeting ``needed_supply`` its/s from
        ``current`` counts, growing spot-first / shrinking spot-first.

        ``floors`` raises a class's effective minimum (deadline-aware
        allocation: demand only that class can serve within its SLA must
        be covered there, regardless of the spot-first greedy order —
        see ``scheduler.deadline_floors``).  Growth still lands on spot
        first; release never drops a class below its floor.

        ``discounts`` maps class name -> effective-throughput multiplier
        (``preemption_discount``): a preemptible class under reclaim
        supplies less useful throughput per provisioned GPU, so meeting
        the same ``needed_supply`` provisions MORE spot GPUs — the
        preemption-aware headroom.  Absent/1.0 entries are bit-exact
        no-ops, so the no-preemption plan is unchanged.

        Reduces exactly to the scalar plan for a homogeneous pool:
        target = clamp(ceil(needed_supply / r_cloud), min, max).
        """
        floors = floors or {}
        rate = {c.name: c.r_cloud * (discounts or {}).get(c.name, 1.0)
                for c in self.classes}
        lo = {c.name: min(max(c.min_count, floors.get(c.name, 0)),
                          c.max_count)
              for c in self.classes}
        targets = {c.name: min(max(current.get(c.name, 0), lo[c.name]),
                               c.max_count)
                   for c in self.classes}
        supply = self.supply(targets, discounts=discounts)
        # the 1e-9 guards absorb float wobble in gap/rate so a demand of
        # exactly k GPUs never rounds to k+1 (or releases one too many)
        if supply < needed_supply:
            for c in self.scale_order():
                gap = needed_supply - supply
                if gap <= 0:
                    break
                add = min(int(math.ceil(gap / rate[c.name] - 1e-9)),
                          c.max_count - targets[c.name])
                add = max(0, add)
                targets[c.name] += add
                supply += add * rate[c.name]
        elif supply > needed_supply:
            for c in self.release_order():
                excess = supply - needed_supply
                if excess <= 0:
                    break
                # keep (count - drop) * r >= needed share: drop whole GPUs
                # only while the remaining supply still covers the need
                drop = min(int(excess / rate[c.name] + 1e-9),
                           targets[c.name] - lo[c.name])
                drop = max(0, drop)
                targets[c.name] -= drop
                supply -= drop * rate[c.name]
        return targets

    # -- serialization -----------------------------------------------------
    def to_json(self) -> List[Dict]:
        """Plain rows (one per class) for dryrun's capacity artifact."""
        return [dataclasses.asdict(c) for c in self.classes]

    @classmethod
    def from_json(cls, rows: Iterable[Mapping]) -> "CloudCapacity":
        return cls(tuple(GpuClass(**dict(r)) for r in rows))

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_scalar(cls, r_cloud: float, count: int, min_count: int = 0,
                    max_count: int = 1024,
                    name: str = "default") -> "CloudCapacity":
        """The homogeneous pool every pre-refactor surface assumed."""
        return cls((GpuClass(name=name, r_cloud=r_cloud, count=count,
                             min_count=min_count, max_count=max_count),))

    @classmethod
    def from_rates(cls, rates: Mapping[str, float], counts: Mapping[str, int],
                   preemptible: Iterable[str] = (),
                   cost_weights: Optional[Mapping[str, float]] = None,
                   reference: Optional[str] = None,
                   max_counts: Optional[Mapping[str, int]] = None,
                   ) -> "CloudCapacity":
        """Build from per-class rate estimates.

        ``cost_weights`` defaults to rate-proportional pricing relative to
        ``reference`` (fastest class when unset) with a 40% discount for
        preemptible classes — the usual spot-market shape.
        """
        if not rates:
            raise ValueError("no rate estimates given")
        spot = set(preemptible)
        ref = reference or max(rates, key=lambda k: rates[k])
        ref_rate = rates[ref]
        classes = []
        for name in sorted(rates):
            if cost_weights is not None and name in cost_weights:
                w = cost_weights[name]
            else:
                w = rates[name] / ref_rate
                if name in spot:
                    w *= 0.6
            classes.append(GpuClass(
                name=name, r_cloud=rates[name],
                count=counts.get(name, 0), preemptible=name in spot,
                cost_weight=w,
                max_count=(max_counts or {}).get(name, 1024)))
        return cls(tuple(classes))

    @classmethod
    def from_roofline(cls, records: Iterable[Mapping],
                      counts: Mapping[str, int],
                      preemptible: Iterable[str] = (),
                      cost_weights: Optional[Mapping[str, float]] = None,
                      cell: Optional[str] = None,
                      ) -> "CloudCapacity":
        """Consume ``launch.dryrun`` records (dryrun.jsonl rows) carrying
        per-hardware ``r_cloud_est`` maps and build calibrated classes.

        Each record is a dict with an ``r_cloud_est`` key mapping hardware
        name -> estimated iterations/s (emitted by
        ``roofline.analysis.r_cloud_estimates``).  Estimates are averaged
        across records; ``cell`` filters to one shape cell first.
        """
        sums: Dict[str, float] = {}
        n: Dict[str, int] = {}
        for rec in records:
            if cell is not None and rec.get("cell") != cell:
                continue
            for hw, rate in (rec.get("r_cloud_est") or {}).items():
                sums[hw] = sums.get(hw, 0.0) + float(rate)
                n[hw] = n.get(hw, 0) + 1
        if not sums:
            raise ValueError("no r_cloud_est entries in the given records "
                             "(run launch.dryrun to produce them)")
        rates = {hw: sums[hw] / n[hw] for hw in sums}
        return cls.from_rates(rates, counts, preemptible=preemptible,
                              cost_weights=cost_weights)


def slice_evenly(total: int, parts: int) -> List[int]:
    """Proportional capacity slices: split ``total`` GPUs across ``parts``
    cohort shards, remainder to the lowest cohort ids.  Deterministic in
    cohort id (never in worker rank), which is what keeps the sharded
    simulation's capacity timeline independent of the worker count."""
    if parts <= 0:
        raise ValueError(f"parts must be > 0, got {parts}")
    base, rem = divmod(int(total), parts)
    return [base + 1 if c < rem else base for c in range(parts)]


def reference_params(params, capacity: CloudCapacity):
    """Derive scalar ``CostParams`` whose ``r_cloud`` is the capacity's
    reference rate — the bridge that keeps every closed-form solve
    working on a heterogeneous pool."""
    return dataclasses.replace(params, r_cloud=capacity.reference_rate())


def preemption_discount(preempt_rate: float, provision_delay_s: float = 0.0,
                        job_s: float = 0.0,
                        restart_loss: float = 0.5) -> float:
    """Expected useful-throughput multiplier for ONE preemptible GPU
    under Poisson spot reclaim at ``preempt_rate`` (reclaims/s per
    provisioned GPU).

    Renewal argument: between reclaims a GPU delivers 1/preempt_rate
    seconds of work on average; each reclaim then costs
    ``provision_delay_s`` of absent capacity (until the autoscaler's
    replacement comes online) plus ``restart_loss * job_s`` of lost
    progress on the job it killed — 0.5 jobs for restart-from-scratch
    (naive requeue kills, on average, a half-done job), ~0 when replans
    carry elapsed-time credit (``Planner.replan_preempted``).  Useful
    fraction of a renewal cycle:

        discount = (1/rate) / (1/rate + delay + loss*job_s)
                 = 1 / (1 + rate * (delay + loss*job_s))

    ``preempt_rate <= 0`` returns exactly 1.0 — the no-preemption
    anchor (``plan_counts``/``deadline_floors`` stay bit-identical).
    """
    if preempt_rate <= 0:
        return 1.0
    overhead = preempt_rate * (max(0.0, provision_delay_s)
                               + max(0.0, restart_loss) * max(0.0, job_s))
    return 1.0 / (1.0 + overhead)
