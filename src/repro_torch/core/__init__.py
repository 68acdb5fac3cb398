"""The paper's contribution: cost model, scheduler, planner, transport
(numpy/stdlib copies of the reference's control plane)."""
