"""Bucketed time-wheel event queue (v2 simulation core).

The v1 fleet simulator keeps a single ``heapq`` of ``(t, kind, seq,
payload)`` tuples: every push and pop pays an O(log n) sift plus the
4-tuple compare.  At 10^6–10^7 arrivals (~3.5 events each) that heap is
a measurable slice of the run.  The wheel trades the total order for a
two-level structure:

* events hash into fixed-width time buckets (``idx = int(t / width)``);
* a small heap orders only the *bucket indices* (one entry per
  non-empty bucket, pushed when the bucket is created);
* within a bucket events run in FIFO insertion order — including events
  appended to the bucket *while it drains* (event handlers only ever
  schedule at ``t' >= t``, so an in-drain push lands in the current or
  a future bucket, never a drained one).

So ordering is exact *across* buckets and FIFO *within* one: the v2
core's documented semantics (docs/sim_core_v2.md).  Events carry their
exact timestamps — only processing order is coarsened, never the times
handlers compute with.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, Iterable, List, Tuple


class EventWheel:
    """Monotone bucketed event queue.

    ``push`` is amortized O(1) (dict get + list append; a heap push only
    when a bucket is first created).  Draining is done by the owner for
    speed: pop the smallest index off ``order``, iterate ``buckets[idx]``
    by position (it may grow mid-drain), then delete the bucket.
    """

    __slots__ = ("width", "inv_width", "buckets", "order")

    def __init__(self, width: float):
        if width <= 0.0:
            raise ValueError(f"bucket width must be positive, got {width}")
        self.width = width
        self.inv_width = 1.0 / width
        self.buckets: Dict[int, List[Tuple[float, int, Any]]] = {}
        self.order: List[int] = []

    def push(self, t: float, kind: int, payload: Any = None) -> None:
        idx = int(t * self.inv_width)
        b = self.buckets.get(idx)
        if b is None:
            self.buckets[idx] = [(t, kind, payload)]
            heapq.heappush(self.order, idx)
        else:
            b.append((t, kind, payload))

    def push_times(self, times: Iterable[float], kind: int) -> None:
        """Bulk-push a monotone batch of payload-free events (the v2
        core's arrival blocks)."""
        buckets = self.buckets
        order = self.order
        inv = self.inv_width
        heappush = heapq.heappush
        for t in times:
            idx = int(t * inv)
            b = buckets.get(idx)
            if b is None:
                buckets[idx] = [(t, kind, None)]
                heappush(order, idx)
            else:
                b.append((t, kind, None))

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets.values())

    def __bool__(self) -> bool:
        return bool(self.order)
