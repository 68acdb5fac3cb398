"""1000-device fleet simulation — reproduces paper §5.4–§5.6.

CALIBRATION (paper does not state t_lim / n_step / k_decode; see
DESIGN.md §8): t_lim=8.5 s, n_step=5, k_decode=2.0 lands within ~2% of
every Table 4 entry with the paper's stated constants (r_cloud=62.5 it/s
RTX4090, fleet ~ N(2.25, 0.28) from iPhone12mini..M2-iPad, t_net=0.3 s,
n_total=50, c_batch=1.6 measured at batch 2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cost_model import CostParams
from repro_torch.core.planner import (
    POLICIES,
    SLOWEST_DEVICE,
    make_scheduler as _planner_make_scheduler,
)
from repro_torch.core.scheduler import (
    IntelligentBatchingScheduler,
    ScheduleSummary,
)
from repro_torch.core.telemetry import DeviceProfile, generate_fleet, upgrade_fleet

CALIBRATED = CostParams(r_cloud=62.5, n_total=50, n_step=5, t_lim=8.5,
                        k_decode=2.0, c_batch=1.6)
# SLOWEST_DEVICE (iPhone 12 mini, paper §5.4) is canonical in
# core.planner and re-exported here for compat
FASTEST_DEVICE = 3.07          # M2 iPad Pro
C_BATCH = 1.6                  # paper §5.5 (batch of 2 on A40)

PROJECTION = CostParams(r_cloud=40.0, n_total=50, n_step=5, t_lim=20.0,
                        k_decode=2.0, c_batch=1.6)


@dataclasses.dataclass
class Table4Row:
    scheduler: str
    cloud_gpu_time: float
    paper_value: Optional[float]
    violations: int
    batched_fraction: float


def table4_fleet(n_devices: int = 1000, seed: int = 0,
                 params: CostParams = CALIBRATED,
                 rtt: float = 0.3) -> List[DeviceProfile]:
    """THE paper fleet (§5.4): N(2.25, 0.28) device rates.  Single
    source for every Table-4 surface — the static path, the event-driven
    simulator's default, and the benchmarks — so the calibration can't
    drift apart between them."""
    return generate_fleet(n_devices, 2.25, 0.28, seed=seed, rtt=rtt,
                          k_decode=params.k_decode)


def run_table4(n_devices: int = 1000, seed: int = 0,
               params: CostParams = CALIBRATED,
               rtt: float = 0.3) -> Dict[str, ScheduleSummary]:
    return run_schedulers(table4_fleet(n_devices, seed, params, rtt), params)


#: The four Table-4 policies, in paper order (canonical definition in
#: core.planner; re-exported here for compat).
assert POLICIES == ("all_cloud", "constant", "variable",
                    "variable+batching")


def table4_capacity(params: CostParams = CALIBRATED, base_count: int = 8,
                    spot_count: int = 8, spot_ratio: float = 0.5,
                    base_max: int = 128, spot_max: int = 128,
                    spot_discount: float = 0.6):
    """The calibrated heterogeneous pool: the Table-4 reference class
    plus preemptible spot GPUs at ``spot_ratio`` of its rate and
    spot-market pricing (rate-proportional cost x ``spot_discount``).

    This is the 2-class configuration the heterogeneity experiments use
    (fast + 0.5x spot); with ``spot_count=0`` + ``spot_max=0`` it
    degenerates to the homogeneous Table-4 pool.  The spot class is
    genuinely preemptible: drive reclaim via
    ``SimConfig.preempt_rate`` / ``preempt_trace``
    (docs/preemption.md) and the fleet simulator kills + re-enters
    in-flight spot jobs.
    """
    from repro_torch.core.capacity import CloudCapacity, GpuClass
    classes = [GpuClass(name="base", r_cloud=params.r_cloud,
                        count=base_count, min_count=1, max_count=base_max)]
    if spot_max > 0:
        classes.append(GpuClass(
            name="spot", r_cloud=params.r_cloud * spot_ratio,
            count=spot_count, preemptible=True,
            cost_weight=spot_ratio * spot_discount, min_count=0,
            max_count=spot_max))
    return CloudCapacity(tuple(classes))


def make_scheduler(name: str, params: CostParams,
                   worst_r_dev: float = SLOWEST_DEVICE,
                   worst_rtt: float = 0.3, batch_size: int = 2,
                   batch_model=None):
    """Thin delegate to ``core.planner.make_scheduler`` — the single
    factory behind the planner, the static snapshot path below, and the
    event-driven ``serving.fleet_sim``, so every surface always runs the
    exact same per-request assignment logic."""
    return _planner_make_scheduler(name, params, worst_r_dev=worst_r_dev,
                                   worst_rtt=worst_rtt,
                                   batch_size=batch_size,
                                   batch_model=batch_model)


def run_schedulers(fleet: List[DeviceProfile],
                   params: CostParams) -> Dict[str, ScheduleSummary]:
    scheds = {name: make_scheduler(name, params, worst_rtt=fleet[0].rtt)
              for name in POLICIES}
    return {name: s.summarize(fleet) for name, s in scheds.items()}


def table4(n_devices: int = 1000, seed: int = 0) -> List[Table4Row]:
    paper = {"all_cloud": 800.0, "constant": 720.0, "variable": 600.96,
             "variable+batching": 487.06}
    out = []
    for name, summ in run_table4(n_devices, seed).items():
        out.append(Table4Row(
            scheduler=name, cloud_gpu_time=summ.total_gpu_time,
            paper_value=paper.get(name), violations=summ.violations,
            batched_fraction=summ.batched_fraction))
    return out


# --------------------------------------------------------------------------
# Time-domain delegation: the event-driven fleet simulator
# (serving.fleet_sim) runs the SAME schedulers over a continuous arrival
# stream; in the steady-state limit its per-request cloud GPU-seconds
# converge to the static totals above.
# --------------------------------------------------------------------------
def fleet_sim_table4(rate: float = 25.0, duration: float = 120.0,
                     seed: int = 0, params: CostParams = CALIBRATED,
                     policies=POLICIES, preempt_rate: float = 0.0,
                     **overrides):
    """Run the event-driven simulator once per policy over the Table-4
    fleet and report cloud GPU-seconds normalized per 1000 requests —
    directly comparable against ``run_table4`` totals.

    ``preempt_rate`` wires spot reclaim into the run (only meaningful
    with a ``capacity=`` override carrying preemptible classes, e.g.
    ``table4_capacity()``); the default 0 keeps the comparison exact.

    Returns {policy: {"gpu_time_per_1000", "p99_latency", "violations",
    "result": FleetSimResult}}.
    """
    from repro_torch.serving.fleet_sim import SimConfig, run_fleet_sim
    fleet = table4_fleet(seed=seed, params=params)
    out = {}
    for name in policies:
        kw = dict(policy=name, params=params, rate=rate,
                  duration=duration, seed=seed, fleet=fleet,
                  preempt_rate=preempt_rate)
        kw.update(overrides)        # explicit overrides win, incl. fleet
        res = run_fleet_sim(SimConfig(**kw))
        out[name] = {
            "gpu_time_per_1000": res.gpu_seconds_per_request() * 1000.0,
            "p99_latency": res.latency_percentile(99),
            "violations": res.violations,
            "result": res,
        }
    return out


# --------------------------------------------------------------------------
# §5.5 batching-cost sweep (paper Fig 14)
# --------------------------------------------------------------------------
def batching_cost_sweep(costs, n_devices: int = 1000, seed: int = 0,
                        params: CostParams = CALIBRATED):
    fleet = generate_fleet(n_devices, 2.25, 0.28, seed=seed, rtt=0.3,
                           k_decode=params.k_decode)
    rows = []
    for c in costs:
        s = IntelligentBatchingScheduler(params, c_batch=c).summarize(fleet)
        rows.append({"c_batch": float(c),
                     "batchable_fraction": s.batched_fraction,
                     "cloud_gpu_time": s.total_gpu_time})
    return rows


# --------------------------------------------------------------------------
# §5.6 projection scenarios (paper Figs 16-20)
# --------------------------------------------------------------------------
def projection_scenarios(n_devices: int = 1000, seed: int = 0):
    """Three fleets: base N(1.0, 0.1); 50% upgraded to 1.5; then 80% of
    remaining 1.0-class and 20% of 1.5-class upgraded to 2.0."""
    p = PROJECTION
    base = generate_fleet(n_devices, 1.0, 0.1, seed=seed, rtt=0.5,
                          k_decode=p.k_decode)
    f2 = upgrade_fleet(base, 0.5, 1.5, 0.15, seed=seed + 1)
    f3 = upgrade_fleet(f2, 0.8, 2.0, 0.2, seed=seed + 2,
                       eligible=lambda d: d.r_dev < 1.25)
    f3 = upgrade_fleet(f3, 0.2, 2.0, 0.2, seed=seed + 3,
                       eligible=lambda d: 1.25 <= d.r_dev < 1.8)
    out = {}
    for name, fleet in (("base", base), ("upgrade_1.5", f2),
                        ("upgrade_2.0", f3)):
        res = run_schedulers(fleet, p)
        allc = res["all_cloud"].total_gpu_time
        out[name] = {
            "rates": [d.r_dev for d in fleet],
            "summaries": res,
            "ratios": {k: v.total_gpu_time / allc for k, v in res.items()},
        }
    return out
