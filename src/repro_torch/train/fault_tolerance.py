"""Fault tolerance: heartbeats, straggler mitigation, elastic restarts.

On a real multi-pod deployment these hooks sit in the coordinator; here
they are driven by a simulation harness (tests + examples/elastic_restart)
exercising the REAL checkpoint/restore/re-mesh code paths:

  * HeartbeatMonitor — mark workers dead after `timeout` missed beats.
  * StragglerDetector — per-step worker durations; flag > factor * median.
    (On the serving side the paper's own n_step grouping IS the straggler
    mitigation: slow devices are simply assigned more cloud iterations.)
  * ElasticPlan — given dead workers, compute the largest (data, model)
    mesh that fits the survivors, to restore a checkpoint onto.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    def __init__(self, worker_ids: Sequence[str], timeout_s: float = 30.0,
                 clock=time.monotonic):
        self._clock = clock
        self.timeout = timeout_s
        self._last: Dict[str, float] = {w: clock() for w in worker_ids}
        self._dead: set = set()

    def beat(self, worker_id: str) -> None:
        if worker_id not in self._dead:
            self._last[worker_id] = self._clock()

    def mark_dead(self, worker_id: str) -> None:
        self._dead.add(worker_id)

    def check(self) -> List[str]:
        now = self._clock()
        for w, t in self._last.items():
            if w not in self._dead and now - t > self.timeout:
                self._dead.add(w)
        return sorted(self._dead)

    @property
    def alive(self) -> List[str]:
        return sorted(set(self._last) - self._dead)


class StragglerDetector:
    """Flags workers whose step time exceeds factor * median."""

    def __init__(self, factor: float = 1.5, window: int = 20):
        self.factor = factor
        self.window = window
        self._history: Dict[str, List[float]] = {}

    def record(self, worker_id: str, duration_s: float) -> None:
        h = self._history.setdefault(worker_id, [])
        h.append(duration_s)
        if len(h) > self.window:
            h.pop(0)

    def _median(self, xs: List[float]) -> float:
        s = sorted(xs)
        return s[len(s) // 2]

    def stragglers(self) -> List[str]:
        means = {w: sum(h) / len(h) for w, h in self._history.items() if h}
        if len(means) < 2:
            return []
        med = self._median(list(means.values()))
        return sorted(w for w, m in means.items()
                      if m > self.factor * med)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pods: int
    dropped_workers: Tuple[str, ...]

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_elastic_mesh(n_alive_chips: int, model_parallel: int,
                      chips_per_pod: int = 256,
                      dropped: Sequence[str] = ()) -> ElasticPlan:
    """Largest (pod, data, model) mesh from the surviving chips.

    Keeps model_parallel fixed (TP degree is a property of the model
    sharding) and shrinks data parallelism — the standard elastic policy:
    batch redistribution, not re-partitioning.
    """
    pods = max(1, n_alive_chips // chips_per_pod)
    usable = pods * chips_per_pod if n_alive_chips >= chips_per_pod else n_alive_chips
    data = max(1, usable // (pods * model_parallel))
    return ElasticPlan(data=data, model=model_parallel, pods=pods,
                       dropped_workers=tuple(dropped))


def recovery_procedure(monitor: HeartbeatMonitor, ckpt_dir: str,
                       template, model_parallel: int,
                       chips_per_worker: int = 4):
    """The full recovery path (used by tests/examples):
    detect dead -> plan smaller mesh -> restore latest checkpoint.

    Returns (plan, step, restored_tree) — caller rebuilds the mesh with
    launch.mesh utilities and ``checkpoint.reshard``s the tree onto it.
    """
    from repro_torch.train import checkpoint as ckpt_lib
    dead = monitor.check()
    alive_chips = len(monitor.alive) * chips_per_worker
    plan = plan_elastic_mesh(alive_chips, model_parallel, dropped=dead)
    step, tree, meta = ckpt_lib.restore(ckpt_dir, template)
    return plan, step, tree
