"""serving subpackage: static Table-4 snapshot (``simulator``), real
split-execution engines (``engine``), the event-driven continuous
simulator (``fleet_sim``), and the decision-trace record/verify/replay
bridge between them (``replay``, docs/engine_replay.md)."""
from repro_torch.serving.fleet_sim import (  # noqa: F401
    FleetSimResult,
    FleetSimulator,
    GpuPool,
    HeterogeneousDispatcher,
    SimConfig,
    run_fleet_sim,
)
from repro_torch.serving.mobility import (  # noqa: F401
    MobilityConfig,
    MobilityModel,
    NetShift,
    SessionLink,
)
from repro_torch.serving.replay import (  # noqa: F401
    Trace,
    TraceWriter,
    read_trace,
    replay_through_engine,
    verify_decisions,
)
from repro_torch.serving.simulator import (  # noqa: F401
    CALIBRATED,
    POLICIES,
    fleet_sim_table4,
    make_scheduler,
    run_table4,
    table4,
    table4_capacity,
    table4_fleet,
)
