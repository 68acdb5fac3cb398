"""SLA policy + adaptive controller (paper §7: tighten when idle, relax
under load to avoid dropping requests) + per-request deadline tracking
for the continuous-serving path."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class SLAPolicy:
    t_lim: float                  # target end-to-end latency, seconds
    t_floor: float = 1.0          # tightest allowed
    t_ceil: float = 60.0          # loosest allowed


class AdaptiveSLAController:
    """Adjust the SLA target from observed cloud utilization.

    utilization > high_water  -> relax t_lim (multiplicative increase)
    utilization < low_water   -> tighten t_lim (slow additive decrease)

    This is the paper's §7 policy knob: under pressure every request is
    still served (more device work per job); when idle, latency improves.
    """

    def __init__(self, policy: SLAPolicy, high_water: float = 0.85,
                 low_water: float = 0.5, relax: float = 1.25,
                 tighten: float = 0.95):
        self.policy = policy
        self.high = high_water
        self.low = low_water
        self.relax = relax
        self.tighten = tighten

    def update(self, utilization: float) -> float:
        t = self.policy.t_lim
        if utilization > self.high:
            t *= self.relax
        elif utilization < self.low:
            t *= self.tighten
        t = min(max(t, self.policy.t_floor), self.policy.t_ceil)
        self.policy.t_lim = t
        return t


# --------------------------------------------------------------------------
# Per-request deadlines (fleet simulator / continuous serving)
# --------------------------------------------------------------------------
class RequestDeadline:
    """One request's SLA clock: fixed at arrival (the paper's contract is
    end-to-end latency from submission, so later SLA-policy changes do not
    move deadlines of in-flight requests).  Plain slots class, not a
    dataclass: one is constructed per request on the simulator's hot
    path.  Treat instances as immutable."""

    __slots__ = ("request_id", "arrival", "t_lim", "deadline")

    def __init__(self, request_id: str, arrival: float, t_lim: float):
        self.request_id = request_id
        self.arrival = arrival
        self.t_lim = t_lim
        #: arrival + t_lim, precomputed: the EDF dispatcher reads it per
        #: queued job, so it must not be a property recomputed per access
        self.deadline = arrival + t_lim

    def slack(self, now: float) -> float:
        return self.deadline - now

    def violated_at(self, completion: float) -> bool:
        return completion > self.deadline + 1e-9


class DeadlineTracker:
    """Book-keeping for in-flight deadlines: open at arrival, close at
    completion; counts violations and exposes the tightest open slack
    (what an EDF-style dispatcher or an autoscaler would watch)."""

    def __init__(self):
        self._open: Dict[str, RequestDeadline] = {}
        self.completed = 0
        self.violations = 0
        # hot-path binding: `get` resolves to the dict's own .get (same
        # semantics as the class method below, one call layer less —
        # the EDF dispatcher asks per queued job)
        self.get = self._open.get

    def open(self, request_id: str, arrival: float,
             t_lim: float) -> RequestDeadline:
        d = RequestDeadline(request_id, arrival, t_lim)
        self._open[request_id] = d
        return d

    def close(self, request_id: str, completion: float) -> bool:
        """Returns True when the request violated its deadline."""
        d = self._open.pop(request_id)
        self.completed += 1
        late = completion > d.deadline + 1e-9   # violated_at, inlined
        if late:
            self.violations += 1
        return late

    def in_flight(self) -> int:
        return len(self._open)

    def get(self, request_id: str) -> Optional[RequestDeadline]:
        """The open deadline for ``request_id`` (None once closed) — what
        an EDF dispatcher reads to order queued work."""
        return self._open.get(request_id)

    def min_slack(self, now: float) -> Optional[float]:
        if not self._open:
            return None
        return min(d.slack(now) for d in self._open.values())
