"""Session network dynamics: drift, handoff, disconnect — the mobility model.

The paper's scheduler exists because mobile network quality *changes*
("collects information about network quality ... making decisions to
achieve consistent performance"), yet until this module a request's
``NetworkProfile`` was frozen at arrival.  ``MobilityModel`` gives every
device in the fleet a *session link* that evolves over simulated time:

* **drift** — a mean-reverting random walk on log-RTT / log-bandwidth,
  pulled back toward the anchor of whichever network the session is on;
* **handoff** — discrete WiFi <-> cellular jumps that reset the link to
  the new network's anchor (cellular = ``cellular_rtt_factor`` x RTT,
  ``cellular_bw_factor`` x bandwidth);
* **disconnect/reconnect** — outage windows during which a session is
  unreachable; modeled latency for anything shipped during the outage
  pays the remaining outage time on top of the live RTT.

The model is driven by its **own rng stream**
(``default_rng(seed + MOBILITY_SEED_SALT)``) so enabling mobility never
perturbs arrival sampling, service jitter, or preemption draws — and,
crucially, the *shift sequence is identical* whether the simulator
replans on degradation or freezes the arrival-time split
(``MobilityConfig.replan``): replanning consumes no mobility
randomness, so A/B comparisons see the same network weather.

``serving/fleet_sim.py`` turns ``next_gap``/``step`` into
``EVT_NET_SHIFT`` simulator events and consults ``degraded`` to decide
when an in-flight job must re-enter the planner
(``Planner.replan_degraded``).  See ``docs/mobility.md``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "MOBILITY_SEED_SALT",
    "MobilityConfig",
    "SessionLink",
    "NetShift",
    "MobilityModel",
]

#: Salt for the dedicated mobility rng stream.  Distinct from the
#: preemption stream's ``0x5EED`` and from ``seed + 1`` (autoscaler
#: jitter) so enabling mobility is rng-invisible to every other model.
MOBILITY_SEED_SALT = 0x4D0B


@dataclass(frozen=True)
class MobilityConfig:
    """Knobs for the session network model (all rates per session).

    ``drift_interval_s`` is the *mean* time between drift steps for one
    session; ``handoff_rate`` / ``disconnect_rate`` are per-second
    Poisson rates per session.  The superposed fleet-wide process is
    what the simulator schedules (one exponential gap at a time).
    """

    # -- drift: mean-reverting random walk on log(rtt), log(bandwidth)
    drift_interval_s: float = 10.0    #: mean seconds between drift steps
    drift_sigma: float = 0.25         #: lognormal step scale per drift
    drift_revert: float = 0.35        #: pull toward the network anchor, in [0, 1]
    # -- handoff: WiFi <-> cellular profile jumps
    handoff_rate: float = 0.0         #: per-session handoffs per second
    cellular_rtt_factor: float = 4.0  #: cellular anchor rtt multiplier (>= 1)
    cellular_bw_factor: float = 0.125  #: cellular anchor bandwidth multiplier (<= 1)
    # -- disconnect / reconnect outage windows
    disconnect_rate: float = 0.0      #: per-session disconnects per second
    outage_mean_s: float = 5.0        #: mean outage duration (exponential)
    # -- replan policy: when does a shift force an in-flight replan?
    replan_rtt_factor: float = 1.5    #: live rtt > factor * planned rtt => degraded
    replan_bw_factor: float = 2.0     #: planned bw > factor * live bw  => degraded
    replan: bool = True               #: False = freeze-at-arrival baseline arm

    def validate(self) -> None:
        if self.drift_interval_s <= 0:
            raise ValueError("mobility: drift_interval_s must be > 0")
        if self.drift_sigma < 0:
            raise ValueError("mobility: drift_sigma must be >= 0")
        if not 0.0 <= self.drift_revert <= 1.0:
            raise ValueError("mobility: drift_revert must be in [0, 1]")
        if self.handoff_rate < 0 or self.disconnect_rate < 0:
            raise ValueError("mobility: event rates must be >= 0")
        if self.cellular_rtt_factor < 1.0:
            raise ValueError("mobility: cellular_rtt_factor must be >= 1")
        if not 0.0 < self.cellular_bw_factor <= 1.0:
            raise ValueError("mobility: cellular_bw_factor must be in (0, 1]")
        if self.outage_mean_s <= 0:
            raise ValueError("mobility: outage_mean_s must be > 0")
        if self.replan_rtt_factor < 1.0 or self.replan_bw_factor < 1.0:
            raise ValueError("mobility: replan factors must be >= 1")

    def to_json(self) -> dict:
        return {
            "drift_interval_s": self.drift_interval_s,
            "drift_sigma": self.drift_sigma,
            "drift_revert": self.drift_revert,
            "handoff_rate": self.handoff_rate,
            "cellular_rtt_factor": self.cellular_rtt_factor,
            "cellular_bw_factor": self.cellular_bw_factor,
            "disconnect_rate": self.disconnect_rate,
            "outage_mean_s": self.outage_mean_s,
            "replan_rtt_factor": self.replan_rtt_factor,
            "replan_bw_factor": self.replan_bw_factor,
            "replan": self.replan,
        }


@dataclass(slots=True)
class SessionLink:
    """Live link state for one device session."""

    device_id: str
    base_rtt: float          #: WiFi anchor rtt (the fleet profile's value)
    base_bw: float           #: WiFi anchor bandwidth
    rtt: float               #: current live rtt
    bandwidth: float         #: current live bandwidth
    network: str = "wifi"    #: "wifi" | "cellular"
    down_until: float = 0.0  #: sim time the current outage ends (0 = up)

    def anchors(self, cfg: MobilityConfig) -> "tuple[float, float]":
        """(rtt, bandwidth) anchor of the *current* network."""
        if self.network == "cellular":
            return (self.base_rtt * cfg.cellular_rtt_factor,
                    self.base_bw * cfg.cellular_bw_factor)
        return (self.base_rtt, self.base_bw)


@dataclass(frozen=True)
class NetShift:
    """One applied network-shift event (what EVT_NET_SHIFT carries)."""

    t: float
    device_id: str
    kind: str            #: "drift" | "handoff" | "disconnect" | "reconnect"
    rtt: float           #: live rtt after the shift
    bandwidth: float     #: live bandwidth after the shift
    network: str
    down_until: float    #: 0.0 unless the session is in an outage

    def to_json(self) -> dict:
        return {
            "t": self.t, "device_id": self.device_id, "kind": self.kind,
            "rtt": self.rtt, "bandwidth": self.bandwidth,
            "network": self.network, "down_until": self.down_until,
        }


class MobilityModel:
    """Fleet-wide session network dynamics on a dedicated rng stream.

    One instance owns a ``SessionLink`` per device in the fleet and a
    superposed Poisson process over all sessions and shift kinds.  The
    simulator alternates ``next_gap()`` (schedule the next
    EVT_NET_SHIFT) and ``step(t)`` (draw session + kind, mutate the
    link, return the applied ``NetShift``).
    """

    def __init__(self, cfg: MobilityConfig, fleet, seed: int) -> None:
        cfg.validate()
        self.cfg = cfg
        self.rng = np.random.default_rng(seed + MOBILITY_SEED_SALT)
        self.sessions: Dict[str, SessionLink] = {}
        self._ids: List[str] = []
        for prof in fleet:
            link = SessionLink(
                device_id=prof.device_id,
                base_rtt=prof.rtt, base_bw=prof.bandwidth,
                rtt=prof.rtt, bandwidth=prof.bandwidth)
            self.sessions[prof.device_id] = link
            self._ids.append(prof.device_id)
        # per-session rates; the fleet process superposes them
        self._r_drift = 1.0 / cfg.drift_interval_s
        self._r_hand = cfg.handoff_rate
        self._r_disc = cfg.disconnect_rate
        self._rate_fleet = (
            len(self._ids) * (self._r_drift + self._r_hand + self._r_disc))
        # counters surfaced in FleetSimResult
        self.n_shifts = 0
        self.n_drifts = 0
        self.n_handoffs = 0
        self.n_disconnects = 0

    # -- event process --------------------------------------------------

    def next_gap(self) -> Optional[float]:
        """Exponential gap to the next fleet-wide shift (None = never)."""
        if self._rate_fleet <= 0.0:
            return None
        return float(self.rng.exponential(1.0 / self._rate_fleet))

    def step(self, t: float) -> Optional[NetShift]:
        """Apply one shift at time ``t``; returns None for a dead draw.

        A draw that lands on a session currently in an outage is a
        no-op (the link is down; drift/handoff resume after reconnect)
        — but it still consumes the *same* rng draws in the same order
        regardless of simulator policy, keeping freeze/replan arms on
        identical weather.
        """
        link = self.sessions[self._ids[int(self.rng.integers(len(self._ids)))]]
        u = float(self.rng.random())
        if t < link.down_until:
            return None
        total = self._r_drift + self._r_hand + self._r_disc
        if u < self._r_drift / total:
            return self._drift(t, link)
        if u < (self._r_drift + self._r_hand) / total:
            return self._handoff(t, link)
        return self._disconnect(t, link)

    def _drift(self, t: float, link: SessionLink) -> NetShift:
        cfg = self.cfg
        a_rtt, a_bw = link.anchors(cfg)
        g_rtt, g_bw = self.rng.normal(size=2)
        rev = cfg.drift_revert
        link.rtt = float(math.exp(
            (1.0 - rev) * math.log(link.rtt) + rev * math.log(a_rtt)
            + cfg.drift_sigma * g_rtt))
        link.bandwidth = float(math.exp(
            (1.0 - rev) * math.log(link.bandwidth) + rev * math.log(a_bw)
            + cfg.drift_sigma * g_bw))
        self.n_shifts += 1
        self.n_drifts += 1
        return self._shift(t, link, "drift")

    def _handoff(self, t: float, link: SessionLink) -> NetShift:
        link.network = "cellular" if link.network == "wifi" else "wifi"
        link.rtt, link.bandwidth = link.anchors(self.cfg)
        self.n_shifts += 1
        self.n_handoffs += 1
        return self._shift(t, link, "handoff")

    def _disconnect(self, t: float, link: SessionLink) -> NetShift:
        link.down_until = t + float(
            self.rng.exponential(self.cfg.outage_mean_s))
        self.n_shifts += 1
        self.n_disconnects += 1
        return self._shift(t, link, "disconnect")

    def reconnect(self, t: float, device_id: str) -> NetShift:
        """Bookkeeping shift when an outage window closes (no rng)."""
        link = self.sessions[device_id]
        link.down_until = 0.0
        self.n_shifts += 1
        return self._shift(t, link, "reconnect")

    def _shift(self, t: float, link: SessionLink, kind: str) -> NetShift:
        return NetShift(
            t=t, device_id=link.device_id, kind=kind,
            rtt=link.rtt, bandwidth=link.bandwidth,
            network=link.network, down_until=link.down_until)

    # -- queries the simulator makes ------------------------------------

    def live_profile(self, prof, t: float):
        """``prof`` with the session's *current* link substituted in.

        During an outage the effective rtt also pays the remaining
        outage time: work shipped now can't land before the session is
        reachable again.
        """
        link = self.sessions.get(prof.device_id)
        if link is None:
            return prof
        rtt = link.rtt + max(0.0, link.down_until - t)
        return replace(prof, rtt=rtt, bandwidth=link.bandwidth)

    def ship_rtt(self, device_id: str, t: float, fallback: float) -> float:
        """Live rtt paid when results ship to the device at time ``t``."""
        link = self.sessions.get(device_id)
        if link is None:
            return fallback
        return link.rtt + max(0.0, link.down_until - t)

    def degraded(self, device_id: str, planned_rtt: float,
                 planned_bw: float, t: float) -> bool:
        """Has the link shifted past the replan thresholds vs the plan?"""
        link = self.sessions.get(device_id)
        if link is None:
            return False
        if t < link.down_until:
            return True
        cfg = self.cfg
        return (link.rtt > cfg.replan_rtt_factor * planned_rtt
                or planned_bw > cfg.replan_bw_factor * link.bandwidth)
