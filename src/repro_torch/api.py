"""repro_torch.api — the one-stop facade for the paper's serving system.

Everything a consumer needs to make (and audit) a split/batching/
capacity decision, or to drive the serving surfaces built on top of it,
imports from here:

    from repro_torch.api import (
        CALIBRATED, DeviceProfile, PlanRequest, Planner,
    )
    planner = Planner(CALIBRATED, policy="variable+batching")
    decision = planner.plan(PlanRequest(device=DeviceProfile("d", 2.25)))
    print(decision.explain())           # which policy set each field
    payload = decision.to_json()        # telemetry-ready
    assert repro_torch.api.replay(payload).to_json() == payload   # deterministic

The facade is intentionally flat and import-cheap (no jax): the planner
protocol (`core.planner`), the cost/capacity model behind it, and the
simulation/serving entry points.  CI runs both examples end-to-end
against this surface, so drift here breaks the build, not users.
"""
from repro_torch.core.capacity import (  # noqa: F401
    CloudCapacity,
    GpuClass,
    preemption_discount,
    reference_params,
)
from repro_torch.core.cost_model import (  # noqa: F401
    BatchModel,
    CostParams,
    cloud_gpu_time,
    e2e_latency,
    fit_batch_model,
    quantize_step,
    solve_n_cloud,
)
from repro_torch.core.planner import (  # noqa: F401
    JobSpec,
    NetworkProfile,
    PLAN_ACTIONS,
    PlanDecision,
    PlanRequest,
    Planner,
    POLICIES,
    PoolSnapshot,
    RoutePolicy,
    ShedPolicy,
    make_scheduler,
    plan,
    replay,
)
from repro_torch.core.scheduler import (  # noqa: F401
    Assignment,
    allocate_gpus,
    allocate_gpus_heterogeneous,
    cheapest_feasible_class,
    deadline_floors,
)
from repro_torch.core.telemetry import (  # noqa: F401
    DeviceProfile,
    generate_fleet,
)
from repro_torch.serving.fleet_sim import (  # noqa: F401
    FleetSimResult,
    SimConfig,
    run_fleet_sim,
)
from repro_torch.core.transport import (  # noqa: F401
    WIRE_FORMATS,
    WireFormat,
    WirePolicy,
)
from repro_torch.serving.mobility import (  # noqa: F401
    MobilityConfig,
)
from repro_torch.serving.replay import (  # noqa: F401
    Trace,
    read_trace,
    replay_through_engine,
    verify_decisions,
)
from repro_torch.serving.simulator import (  # noqa: F401
    CALIBRATED,
    fleet_sim_table4,
    run_table4,
    table4_capacity,
    table4_fleet,
)
from repro_torch.train.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    StragglerDetector,
    plan_elastic_mesh,
)

__all__ = [
    # planner protocol
    "JobSpec", "NetworkProfile", "PLAN_ACTIONS", "PlanDecision",
    "PlanRequest", "Planner", "PoolSnapshot", "RoutePolicy", "ShedPolicy",
    "POLICIES", "make_scheduler", "plan", "replay",
    # cost / capacity model
    "BatchModel", "CloudCapacity", "CostParams", "GpuClass", "Assignment",
    "cloud_gpu_time", "e2e_latency", "fit_batch_model", "quantize_step",
    "solve_n_cloud", "reference_params", "preemption_discount",
    "allocate_gpus", "allocate_gpus_heterogeneous",
    "cheapest_feasible_class", "deadline_floors",
    # fleets + serving entry points
    "DeviceProfile", "generate_fleet", "FleetSimResult", "SimConfig",
    "MobilityConfig", "run_fleet_sim", "CALIBRATED", "fleet_sim_table4",
    "run_table4", "table4_capacity", "table4_fleet",
    # boundary wire formats (docs/transport.md)
    "WIRE_FORMATS", "WireFormat", "WirePolicy",
    # engine-in-the-loop trace replay (docs/engine_replay.md; the
    # engine-executing half lazily imports jax inside the call)
    "Trace", "read_trace", "verify_decisions", "replay_through_engine",
    # coordinator-side fault tolerance (jax-free; the training loop
    # itself stays a direct repro_torch.train import)
    "HeartbeatMonitor", "StragglerDetector", "plan_elastic_mesh",
]
