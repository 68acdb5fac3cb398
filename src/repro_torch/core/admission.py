"""Online batching admission (paper §4.4) for continuous serving.

The static ``IntelligentBatchingScheduler`` pairs requests *within a
fleet snapshot*: it can look at the whole group and batch everyone who
tolerates the batched rate.  In a continuous system requests arrive one
at a time, so admission becomes an *online* decision made at arrival:

    may this request WAIT in its n_final group's batching window,
    given that waiting w seconds and then running at the batched
    cloud rate must still meet its SLA?

The paper's admission test ("a request is batchable if it still meets
its SLA at the batched rate", §4.4) is the w == 0 case; the online form
additionally yields the maximum tolerable wait, which the fleet
simulator uses as the member's window deadline — a window flushes early
when its tightest member would otherwise go stale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cost_model import (
    BatchModel,
    CostParams,
    c_batch_at,
    e2e_latency,
)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admit: bool               # join the batching window (wait for peers)?
    max_wait: float           # longest tolerable wait at the batched rate
    batched_latency: float    # predicted no-wait latency at the batched rate
    solo_latency: float       # predicted latency running alone immediately
    reason: str = ""


class BatchingAdmission:
    """§4.4 admission, online form.

    ``queue_delay_hint``: the caller's current estimate of cloud queueing
    delay (the window wait is *on top of* any GPU queue); subtracting it
    keeps admissions honest when the pool is backed up.
    """

    def __init__(self, params: CostParams, c_batch: float,
                 batch_size: int = 2,
                 batch_model: Optional[BatchModel] = None):
        self.p = params
        # c_batch is measured at batch 2; at other batch sizes use the
        # §4.4 linear micro-model extrapolation — unless a fitted
        # BatchModel from real multi-point timings is given
        self.batch_model = batch_model
        if batch_model is not None:
            self.c_batch = batch_model.c_batch(batch_size)
        else:
            self.c_batch = c_batch_at(c_batch, batch_size)
        self.batch_size = batch_size
        # batching must actually save accelerator time to be worth the
        # wait (same guard as the static scheduler): c_batch < batch_size
        self.saves_time = self.c_batch < batch_size

    def latencies(self, n_final: int, r_dev: float,
                  rtt: float) -> "tuple[float, float]":
        """The hint-independent part of a decision: (solo, batched)
        predicted latencies.  Split out so the planner's ``PlanCache``
        can memoize them per device profile and re-run only the cheap
        hint-dependent verdict (``decide_from``) per request."""
        solo = e2e_latency(n_final, r_dev, self.p, rtt, c_batch=1.0)
        batched = e2e_latency(n_final, r_dev, self.p, rtt,
                              c_batch=self.c_batch)
        return solo, batched

    def decide(self, n_final: int, r_dev: float, rtt: float,
               queue_delay_hint: float = 0.0) -> AdmissionDecision:
        solo, batched = self.latencies(n_final, r_dev, rtt)
        return self.decide_from(n_final, solo, batched, queue_delay_hint)

    def decide_from(self, n_final: int, solo: float, batched: float,
                    queue_delay_hint: float = 0.0) -> AdmissionDecision:
        """The verdict given precomputed latencies — THE branch logic
        (``decide`` and the planner's cached path both end here, so the
        two can never drift)."""
        if n_final <= 0:
            return AdmissionDecision(False, 0.0, batched, solo,
                                     "local-only request; nothing to batch")
        if not self.saves_time:
            return AdmissionDecision(False, 0.0, batched, solo,
                                     "c_batch >= batch_size: batching does "
                                     "not save GPU time")
        max_wait = self.p.t_lim - batched - queue_delay_hint
        if max_wait <= 0.0:
            return AdmissionDecision(False, 0.0, batched, solo,
                                     "SLA not met at the batched rate")
        return AdmissionDecision(True, max_wait, batched, solo,
                                 "meets SLA at batched rate")
