"""Multiprocess cohort-sharded simulation: parallel v2 fast lanes with
barrier'd capacity exchange (docs/sim_core_v2.md, "Multiprocess
sharding").

The fleet is partitioned into C cohort shards (``fleet[c::C]``), each
running a faithful port of the v2 chunked fast lane
(``FleetSimulatorV2._run_fast``) over *time-aligned* chunks of width
``SimConfig.shard_chunk_s``.  P worker processes own ``C/P`` lanes each
(worker ``w`` owns cohorts ``{c : c % P == w}``); at every chunk
boundary a BSP barrier folds compact per-lane aggregates — per-class
demand counts, queue depth, utilization integrals — so the §4.5
autoscaler and the §4.4 admission queue-delay hint operate on
*fleet-wide* state, while planning, arrival generation and completion
accounting stay embarrassingly parallel per cohort.

Determinism and P-invariance:

* the cohort count C (``SimConfig.shard_cohorts``, default
  ``max(8, processes)``) is decoupled from the worker count P, and every
  cohort draws its own rng substream
  (``np.random.SeedSequence((seed, tag, cohort))``), so aggregate
  results depend only on ``(seed, C)`` — NOT on P;
* all coordinator folds iterate cohorts in id order, and the final
  telemetry merge (``StreamingLatencyStats.merged``) folds lane streams
  in cohort order, so even the P² marker states are bit-identical
  across P;
* ``processes=1`` *without* ``shard_cohorts`` never enters this module
  at all (``FleetSimulatorV2.run`` routes straight to ``_run_fast``),
  so the default path stays bit-identical to the v2 fast lane.

Chunk-granular approximations (all bounded by ``shard_chunk_s``, on top
of the fast lane's own inner-chunk approximations):

* the demand window feeding the autoscaler advances at barrier
  granularity (per-class counts are stamped at the barrier time);
* autoscale/metrics ticks due within a chunk are evaluated at the
  barrier with barrier-time state; metrics rows therefore carry no
  p50/p99/min_slack (None) — percentiles live in the final merged
  stream;
* capacity releases decided at a barrier apply at the *next* chunk
  start; provision adds keep their exact ``provision_delay_s`` stamp
  (quantized up to the decision barrier, never earlier);
* the admission queue-delay hint blends the lane's live queue with the
  other lanes' barrier-frozen queue/capacity totals;
* each lane's capacity slice is floored at one server (release targets
  are floored at C fleet-wide), so every lane drains and the run
  terminates.

Counters, gpu-seconds and capacity integrals fold exactly; the sharded
mode pins its own golden aggregates and is validated against the
single-process cores as oracle (tests/test_shard_sim.py).

Worker protocol (spawn-safe: no fork-dependent state, workers rebuild
their Planner from the pickled ``SimConfig``):

    coordinator                         worker w (cohorts c % P == w)
    -----------                         -----------------------------
    spawn(_worker_main, cfg, ...)  -->  build Planner + CohortLanes
                                   <--  ("ready", w, None)
    per chunk k, T = k*chunk_s:
      ("step", T, {c: (cap_events,
                       hint_queue,
                       hint_cap)})  -->  lane.advance(T, ...) each
                                   <--  ("rep", w, {c: report})
      fold reports in cohort order; run autoscaler once; schedule
      per-cohort capacity events; emit metrics rows
    ("fin", {c: trailing_events})  -->  lane.finalize(...) each
                                   <--  ("fin", w, ({c: report +
                                         stream}, peak_rss_mb))
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import multiprocessing as mp
import os
import resource
import traceback
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.capacity import reference_params, slice_evenly
from repro_torch.core.cost_model import BatchModel, e2e_latency
from repro_torch.core.planner import Planner
from repro_torch.core.scheduler import fold_demand_counts, plan_capacity_targets
from repro_torch.core.telemetry import (
    StreamingLatencyStats,
    bursty_arrival_blocks,
    diurnal_arrival_blocks,
    poisson_arrival_blocks,
)

# capacity wire-event kinds: (t, kind, value) tuples; ADD sorts before
# REL at equal timestamps, so same-tick provisions land before releases.
# TAKE is the donor half of a barrier rebalancing move (see run_sharded):
# a pure capacity delta that conserves the fleet total and does NOT
# count as a release
_ADD = 0
_REL = 1
_TAKE = 2

# substream tags: disjoint SeedSequence families for the per-cohort
# arrival process and the per-cohort uniform-sampling stream
_ARR_TAG = 0x51AD
_SAMP_TAG = 0x5A3F


def _substream(seed: int, tag: int, cohort: int) -> np.random.SeedSequence:
    """Per-cohort rng substream: depends only on (seed, tag, cohort) —
    never on the worker count — which is what makes sharded results
    P-invariant."""
    return np.random.SeedSequence((seed & 0xFFFFFFFFFFFFFFFF, tag, cohort))


def _cohort_arrival_blocks(cfg, cohort: int, C: int):
    """Cohort ``c``'s arrival stream: the fleet process thinned to
    ``rate/C`` (Poisson superposition — C independent substreams at
    rate/C compose to the fleet rate; bursty/diurnal keep their shape
    with scaled amplitude) on the cohort's own substream."""
    rate_c = cfg.rate / C
    ss = _substream(cfg.seed, _ARR_TAG, cohort)
    if cfg.process == "poisson":
        max_rate_c = cfg.max_rate / C if cfg.max_rate is not None else None
        return poisson_arrival_blocks(rate_c, cfg.duration, seed=ss,
                                      max_rate=max_rate_c)
    if cfg.process == "bursty":
        return bursty_arrival_blocks(rate_c, cfg.duration, seed=ss)
    if cfg.process == "diurnal":
        return diurnal_arrival_blocks(rate_c, cfg.duration, seed=ss,
                                      period_s=cfg.diurnal_period_s)
    raise ValueError(f"unknown arrival process {cfg.process!r}")


def _distribute_add(k: int, proj: List[int]) -> List[int]:
    """Split ``k`` provisioned GPUs across cohorts toward equal
    projected slices (smallest projection first, ties by cohort id —
    deterministic, so the capacity timeline is P-invariant)."""
    give = [0] * len(proj)
    h = [(p, c) for c, p in enumerate(proj)]
    heapq.heapify(h)
    for _ in range(k):
        p, c = heapq.heappop(h)
        give[c] += 1
        heapq.heappush(h, (p + 1, c))
    return give


class CohortLane:
    """One cohort's v2 fast lane, driven in barrier-aligned chunks.

    A line-for-line port of ``FleetSimulatorV2._run_fast`` scoped to
    ``fleet[cohort::C]`` and a private capacity slice: same inner chunk
    width formula (at the cohort rate), same FIFO pool algorithm on
    plain floats, same completion bucketing and admission branch.  What
    the lane does NOT do is autoscale or emit metrics — capacity
    arrives as timed wire events from the coordinator, and each
    ``advance(T, ...)`` returns the compact aggregate report the
    coordinator folds at the barrier.

    State lives in closure cells (the fast-lane idiom): ``__init__``
    builds the whole machine and exposes ``advance``/``finalize``.
    """

    __slots__ = ("cohort", "advance", "finalize")

    def __init__(self, cohort: int, cfg, fleet, planner: Planner, p,
                 cap0: int, C: int, chunk_s: float, cls_rate: float):
        self.cohort = cohort
        lane_fleet = fleet[cohort::C]
        if not lane_fleet:
            raise ValueError(f"cohort {cohort} is empty: shard_cohorts="
                             f"{C} exceeds fleet size {len(fleet)}")
        if cap0 < 1:
            raise ValueError(f"cohort {cohort} got capacity slice "
                             f"{cap0}; every lane needs >= 1 server")
        entries = planner._solve_cohort(lane_fleet)

        t_lim = p.t_lim
        n_total = p.n_total
        k_decode = p.k_decode
        batch_size = cfg.batch_size
        window_s = cfg.window_s
        c_batch_of = planner.c_batch_of
        admission = planner.admission
        cb_full = c_batch_of(batch_size) if admission is not None else 1.0

        nf_l = [e.asg.n_final for e in entries]
        deny_l = [e.deny_slack for e in entries]   # -inf: never batch
        tail_l = [pr.rtt + (n_total - nf_l[i]) / pr.r_dev
                  + k_decode / pr.r_dev
                  for i, pr in enumerate(lane_fleet)]
        local_l = [e2e_latency(0, pr.r_dev, p, pr.rtt, c_batch=1.0)
                   for pr in lane_fleet]
        Fc = len(lane_fleet)

        # inner chunk width: the fast-lane formula at the COHORT rate
        # (~256 arrivals per inner chunk per lane), snapped so an
        # integral number of inner chunks tiles one barrier chunk
        rate_c = cfg.rate / C
        q = 256.0 / rate_c if rate_c > 0 else 1.0
        if admission is not None:
            q = min(q, window_s / 4.0)
        if cfg.autoscale:
            q = min(q, cfg.autoscale_interval_s)
        q = max(min(q, cfg.metrics_interval_s, 0.05 * t_lim), 1e-3)
        n_sub = max(1, math.ceil(chunk_s / q - 1e-9))
        q = chunk_s / n_sub
        inv_q = 1.0 / q

        # -- mutable lane state (closure cells) --
        cap = cap0
        peak = cap0
        released_total = 0
        ends: List[float] = []
        queue: deque = deque()
        queued_service = 0.0
        committed = 0.0                 # gpu-seconds, charged at start
        cap_int = 0.0
        last_cap_t = 0.0
        cap_events: deque = deque()     # (t, kind, value) from coord
        comp_buckets: Dict[int, List[Tuple[float, float, bool, float]]] = {}
        comp_n = 0
        drain_ci = 0
        windows: Dict[int, list] = {}   # n_final -> [flush_at, members]
        stream = StreamingLatencyStats()
        n_arr = 0
        n_jobs = 0
        n_ev = 0
        completed_n = 0
        violations_n = 0
        last_t = 0.0
        t_base = 0.0                    # last barrier reached
        blocks = _cohort_arrival_blocks(cfg, cohort, C)
        buf: Optional[List[float]] = None
        idx_buf: Optional[List[int]] = None
        bi = 0
        ord_ = 0
        samp_rng = (np.random.default_rng(
            _substream(cfg.seed + 1, _SAMP_TAG, cohort))
            if cfg.sampling == "uniform" else None)
        heappush = heapq.heappush
        heappop = heapq.heappop

        def start_job(start: float, service: float, members) -> None:
            nonlocal committed, comp_n
            committed += service
            end = start + service
            heappush(ends, end)
            b01 = len(members) >= 2
            comp_n += len(members)
            for ta, ix in members:
                done = end + tail_l[ix]
                ci = int(done * inv_q)
                b = comp_buckets.get(ci)
                if b is None:
                    comp_buckets[ci] = [(done, done - ta, b01, ta + t_lim)]
                else:
                    b.append((done, done - ta, b01, ta + t_lim))

        def settle(now: float) -> None:
            nonlocal queued_service
            while ends and ends[0] <= now:
                e = heappop(ends)
                if queue:
                    service, members = queue.popleft()
                    queued_service -= service
                    start_job(e, service, members)

        def dispatch(now: float, members) -> None:
            nonlocal queued_service, n_jobs
            n_jobs += 1
            b = len(members)
            n = nf_l[members[0][1]]
            cb = (cb_full if b == batch_size
                  else 1.0 if b == 1 else c_batch_of(b))
            service = n * cb / cls_rate
            settle(now)
            if len(ends) < cap:
                start_job(now, service, members)
            else:
                queue.append((service, members))
                queued_service += service

        def apply_cap_events(upto: float) -> None:
            nonlocal cap, cap_int, last_cap_t, peak, n_ev, last_t
            nonlocal queued_service, released_total
            while cap_events and cap_events[0][0] <= upto:
                ta, kind, v = cap_events.popleft()
                settle(ta)
                cap_int += cap * (ta - last_cap_t)
                last_cap_t = ta
                if kind == _ADD:
                    cap += v
                    if cap > peak:
                        peak = cap
                    if ta > last_t:
                        last_t = ta
                    n_ev += 1
                    while queue and len(ends) < cap:
                        service, members = queue.popleft()
                        queued_service -= service
                        start_job(ta, service, members)
                elif kind == _REL:
                    # release down to the coordinator's slice, clamped
                    # by live busy servers (== fast-lane release_to)
                    tgt = v if v > len(ends) else len(ends)
                    if tgt < cap:
                        released_total += cap - tgt
                        cap = tgt
                else:       # _TAKE: donor half of a rebalancing move
                    cap -= v

        def drain_completions(upto: float) -> None:
            nonlocal completed_n, violations_n, last_t, comp_n, drain_ci
            if upto == math.inf:
                hi = max(comp_buckets) + 1 if comp_buckets else drain_ci
            else:
                hi = int(upto * inv_q)
            while drain_ci < hi:
                b = comp_buckets.pop(drain_ci, None)
                drain_ci += 1
                if b is None:
                    continue
                lats = []
                nb = 0
                viol = 0
                mx = 0.0
                for done, lat, b01, dl in b:
                    lats.append(lat)
                    if b01:
                        nb += 1
                    if done > dl + 1e-9:    # DeadlineTracker.close
                        viol += 1
                    if done > mx:
                        mx = done
                completed_n += len(b)
                comp_n -= len(b)
                violations_n += viol
                stream.add_many(lats, nb)
                if mx > last_t:
                    last_t = mx

        def report(T: float, cc: Dict[int, int]) -> Dict:
            win_depth = sum(len(w[1]) for w in windows.values())
            qmem = sum(len(m) for _, m in queue)
            return {
                "cc": cc,
                "arrivals": n_arr, "jobs": n_jobs, "events": n_ev,
                "completed": completed_n, "violations": violations_n,
                "cap": cap, "busy": len(ends), "queue_len": len(queue),
                "queued_service": queued_service,
                "in_flight": comp_n + win_depth + qmem,
                "win_depth": win_depth,
                "committed": committed,
                "busy_int": committed - sum(e - T for e in ends),
                "cap_int": cap_int + cap * (T - last_cap_t),
                "released": released_total, "peak": peak,
                "last_t": last_t,
                "done": (blocks is None and buf is None
                         and not comp_buckets and not windows
                         and not queue),
            }

        def advance(T1: float, events, hq: float, hc: int) -> Dict:
            """Run the lane through the chunk ``(t_base, T1]``.

            ``events`` are the coordinator's due capacity events
            (applied at their own timestamps, in order); ``hq``/``hc``
            are the OTHER lanes' barrier-frozen queued-service and
            capacity totals, blended into the admission hint."""
            nonlocal buf, idx_buf, bi, blocks, ord_, n_arr, comp_n
            nonlocal n_ev, t_base
            if events:
                cap_events.extend(events)
            cc: Dict[int, int] = {}
            t0 = t_base
            step = (T1 - t0) / n_sub
            for j in range(1, n_sub + 1):
                t1 = T1 if j == n_sub else t0 + j * step
                if buf is not None and bi >= len(buf):
                    buf = None
                if buf is None and blocks is not None:
                    for blk in blocks:
                        if len(blk):
                            buf = blk.tolist()
                            if samp_rng is not None:
                                idx_buf = samp_rng.integers(
                                    0, Fc, size=len(buf)).tolist()
                            bi = 0
                            break
                    else:
                        blocks = None
                apply_cap_events(t1)
                settle(t1 - step)
                drain_completions(t1 - step)
                while buf is not None:
                    t_a = buf[bi]
                    if t_a >= t1:
                        break
                    ix = idx_buf[bi] if samp_rng is not None else ord_
                    bi += 1
                    if samp_rng is None:
                        ord_ += 1
                        if ord_ == Fc:
                            ord_ = 0
                    n_arr += 1
                    n = nf_l[ix]
                    cc[n] = cc.get(n, 0) + 1
                    if n <= 0:
                        # device-only: local closed form
                        lat = local_l[ix]
                        done = t_a + lat
                        ci = int(done * inv_q)
                        b = comp_buckets.get(ci)
                        if b is None:
                            comp_buckets[ci] = [(done, lat, False,
                                                 t_a + t_lim)]
                        else:
                            b.append((done, lat, False, t_a + t_lim))
                        comp_n += 1
                        if bi >= len(buf):
                            break
                        continue
                    settle(t_a)
                    # fleet-wide admission hint: live local queue +
                    # barrier-frozen remote components
                    denom = cap + hc
                    qd = ((queued_service + hq)
                          / (denom if denom > 0 else 1)
                          if (queue or hq > 0.0) else 0.0)
                    if deny_l[ix] > qd:     # decide_from: max_wait > 0
                        w = windows.get(n)
                        mw = deny_l[ix] - qd
                        stale = t_a + (window_s if window_s < mw else mw)
                        if w is None:
                            windows[n] = [stale, [(t_a, ix)]]
                            n_ev += 1
                        else:
                            mem = w[1]
                            mem.append((t_a, ix))
                            if len(mem) >= batch_size:
                                del windows[n]
                                dispatch(t_a, mem)
                            elif stale < w[0]:
                                w[0] = stale
                    else:
                        dispatch(t_a, ((t_a, ix),))
                    if bi >= len(buf):
                        break
                if windows:
                    expired = [n for n, w in windows.items()
                               if w[0] < t1]
                    for n in expired:
                        w = windows.pop(n)
                        n_ev += 1
                        dispatch(w[0], w[1])
            t_base = T1
            settle(T1)
            return report(T1, cc)

        def finalize(events) -> Dict:
            """Trailing drain, mirroring the fast-lane epilogue:
            apply remaining capacity, settle, drain every completion
            bucket, close the capacity integral."""
            nonlocal cap_int, last_cap_t
            if events:
                cap_events.extend(events)
            apply_cap_events(math.inf)
            settle(last_t)
            drain_completions(math.inf)
            cap_int += cap * (last_t - last_cap_t)
            last_cap_t = last_t
            rep = report(last_t, {})
            rep["stream"] = stream
            return rep

        self.advance = advance
        self.finalize = finalize


class _ShardWorker:
    """One worker process: builds its own Planner from the pickled
    config (spawn-safe — nothing is inherited by fork) and drives the
    lanes it owns."""

    def __init__(self, cfg, cohorts: List[int], caps: List[int],
                 C: int, chunk_s: float, cls_rate: float):
        capacity_spec = cfg.build_capacity()
        p = reference_params(cfg.params, capacity_spec)
        fleet = cfg.fleet            # resolved by the coordinator
        planner = Planner(
            p, policy=cfg.policy, capacity=capacity_spec,
            batch_size=cfg.batch_size,
            batch_model=(BatchModel.from_timings(cfg.batch_timings)
                         if cfg.batch_timings else None),
            worst_rtt=fleet[0].rtt, dispatch=cfg.dispatch, audit=False,
            shed_policy=None,        # shedding is a fast-lane blocker
            wire=cfg.wire, cache=cfg.plan_cache)
        self.lanes = {c: CohortLane(c, cfg, fleet, planner, p, caps[i],
                                    C, chunk_s, cls_rate)
                      for i, c in enumerate(cohorts)}

    def step(self, T: float, per_cohort: Dict) -> Dict:
        return {c: self.lanes[c].advance(T, ev, hq, hc)
                for c, (ev, hq, hc) in per_cohort.items()}

    def fin(self, per_cohort: Dict) -> Dict:
        return {c: lane.finalize(per_cohort.get(c, ()))
                for c, lane in self.lanes.items()}


def _worker_main(wid: int, cmd_q, rep_q, payload) -> None:
    """Spawn entry point: build the worker, then serve step/fin
    commands until fin.  Any exception ships back as ("err", ...)."""
    try:
        worker = _ShardWorker(*payload)
        rep_q.put(("ready", wid, None))
        while True:
            msg = cmd_q.get()
            if msg[0] == "step":
                rep_q.put(("rep", wid, worker.step(msg[1], msg[2])))
            elif msg[0] == "fin":
                reports = worker.fin(msg[1])
                rss = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                       / 1024.0)
                rep_q.put(("fin", wid, (reports, rss)))
                return
            else:
                raise RuntimeError(f"unknown command {msg[0]!r}")
    except BaseException:
        rep_q.put(("err", wid, traceback.format_exc()))


class _InProcessDriver:
    """P=1 (or shard_cohorts without extra processes): the same
    _ShardWorker, driven inline — numerics identical to the spawn path
    by construction (same code, same fold order)."""

    def __init__(self, payloads):
        self.workers = [_ShardWorker(*pl) for pl in payloads]

    def step(self, T: float, per_w: Dict) -> Dict:
        out: Dict = {}
        for wid, w in enumerate(self.workers):
            out.update(w.step(T, per_w.get(wid, {})))
        return out

    def fin(self, per_w: Dict) -> Tuple[Dict, List[float]]:
        reports: Dict = {}
        for wid, w in enumerate(self.workers):
            reports.update(w.fin(per_w.get(wid, {})))
        return reports, []

    def close(self) -> None:
        pass


def _ensure_child_importable() -> None:
    """Spawned children re-import this module by qualified name; make
    sure the package root is on their PYTHONPATH even when the parent
    got it via sys.path manipulation."""
    import repro_torch
    pkg_dir = (os.path.dirname(repro_torch.__file__)
               if getattr(repro_torch, "__file__", None)
               else list(repro_torch.__path__)[0])
    root = os.path.dirname(os.path.abspath(pkg_dir))
    pp = os.environ.get("PYTHONPATH", "")
    parts = pp.split(os.pathsep) if pp else []
    if root not in parts:
        os.environ["PYTHONPATH"] = os.pathsep.join([root] + parts)


class _SpawnDriver:
    """P>1: one spawned process per worker, a command queue each and a
    shared reply queue."""

    def __init__(self, payloads):
        _ensure_child_importable()
        ctx = mp.get_context("spawn")
        self.rep_q = ctx.Queue()
        self.cmd_qs = []
        self.procs = []
        for wid, pl in enumerate(payloads):
            q = ctx.SimpleQueue()
            proc = ctx.Process(target=_worker_main,
                               args=(wid, q, self.rep_q, pl),
                               daemon=True)
            proc.start()
            self.cmd_qs.append(q)
            self.procs.append(proc)
        self._collect("ready")

    def _collect(self, want: str) -> Dict:
        import queue as _queue
        outs: Dict = {}
        while len(outs) < len(self.cmd_qs):
            try:
                msg = self.rep_q.get(timeout=5.0)
            except _queue.Empty:
                # a child that dies during bootstrap (e.g. spawn cannot
                # re-import __main__ — interactive stdin parents) never
                # reaches _worker_main's error handler; surface that
                # instead of blocking forever
                dead = [w for w, pr in enumerate(self.procs)
                        if not pr.is_alive() and w not in outs]
                if dead:
                    raise RuntimeError(
                        f"shard worker(s) {dead} exited without a "
                        f"reply (exit codes "
                        f"{[self.procs[w].exitcode for w in dead]}); "
                        f"spawn-based sharding needs an importable "
                        f"__main__ (run from a script or module, or "
                        f"use processes=1)")
                continue
            if msg[0] == "err":
                raise RuntimeError(
                    f"shard worker {msg[1]} failed:\n{msg[2]}")
            if msg[0] != want:
                raise RuntimeError(f"unexpected reply {msg[0]!r} from "
                                   f"worker {msg[1]} (wanted {want!r})")
            outs[msg[1]] = msg[2]
        return outs

    def step(self, T: float, per_w: Dict) -> Dict:
        for wid, q in enumerate(self.cmd_qs):
            q.put(("step", T, per_w.get(wid, {})))
        merged: Dict = {}
        for d in self._collect("rep").values():
            merged.update(d)
        return merged

    def fin(self, per_w: Dict) -> Tuple[Dict, List[float]]:
        for wid, q in enumerate(self.cmd_qs):
            q.put(("fin", per_w.get(wid, {})))
        outs = self._collect("fin")
        reports: Dict = {}
        rss = [0.0] * len(self.cmd_qs)
        for wid, (d, r) in outs.items():
            reports.update(d)
            rss[wid] = r
        for proc in self.procs:
            proc.join(timeout=30)
        return reports, rss

    def close(self) -> None:
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()


def run_sharded(sim) -> "FleetSimResult":
    """BSP coordinator: drive C cohort lanes across P workers in
    barrier-aligned chunks, fold aggregates at each barrier, run the
    §4.5 autoscaler once per tick on fleet-wide demand, and write the
    folded totals back into ``sim`` so ``_build_result`` / per-class
    stats read exactly what the fast lane would have written.

    Called from ``FleetSimulatorV2.run`` after the fast-lane blocker
    check, so every lane config is fast-lane eligible by construction.
    """
    cfg = sim.cfg
    fleet = sim.fleet
    C = cfg.resolved_shard_cohorts()
    chunk_s = cfg.resolved_shard_chunk_s()
    P = min(cfg.processes, C)
    if C > len(fleet):
        raise ValueError(
            f"shard_cohorts={C} exceeds fleet size {len(fleet)}; every "
            f"cohort needs at least one device profile")
    pl = sim.pool._single_pool
    cap0 = pl.capacity
    if cap0 < C:
        raise ValueError(
            f"sharded mode needs initial capacity >= cohorts "
            f"({cap0} < {C}): every lane keeps >= 1 server so the "
            f"run terminates; lower shard_cohorts or raise gpus_init")
    cls = pl.gpu_class
    cls_name = cls.name if cls is not None else "gpu"
    cls_rate = cls.r_cloud if cls is not None else sim.p.r_cloud
    weight = pl.cost_weight
    min_gpus = pl.min_gpus
    cb_full = (sim.planner.c_batch_of(cfg.batch_size)
               if sim.planner.admission is not None else 1.0)

    assigned = slice_evenly(cap0, C)
    cfg_w = dataclasses.replace(cfg, fleet=fleet)
    owner = [c % P for c in range(C)]
    cohorts_of = [[c for c in range(C) if c % P == w] for w in range(P)]
    payloads = [(cfg_w, cohorts_of[w],
                 [assigned[c] for c in cohorts_of[w]],
                 C, chunk_s, cls_rate) for w in range(P)]
    driver = (_SpawnDriver(payloads) if P > 1
              else _InProcessDriver(payloads))

    # -- coordinator state --
    caps = list(assigned)               # per-cohort capacity (reported)
    qs = [0.0] * C                      # per-cohort queued_service
    outbox: List[List[Tuple]] = [[] for _ in range(C)]  # unsent events
    add_pending: List[List[Tuple[float, int]]] = [[] for _ in range(C)]
    demand: deque = deque()             # (T, {n_final: count})
    wg_counts: Dict[int, int] = {}
    rows: List[Dict] = []
    last_busy_int = 0.0
    last_cap_int = 0.0
    peak_total = cap0
    n_ticks = 0
    max_tick_t = 0.0
    next_autoscale = (cfg.autoscale_interval_s if cfg.autoscale
                      else math.inf)
    next_metrics = cfg.metrics_interval_s
    reports: Dict[int, Dict] = {}
    done = [False] * C
    k = 0

    try:
        while not all(done):
            k += 1
            T = k * chunk_s
            hq_total = sum(qs)
            hcap_total = sum(caps)
            per_w: Dict[int, Dict] = {w: {} for w in range(P)}
            for c in range(C):
                due = [ev for ev in outbox[c] if ev[0] <= T]
                if due:
                    outbox[c] = [ev for ev in outbox[c] if ev[0] > T]
                    due.sort()
                per_w[owner[c]][c] = (due, hq_total - qs[c],
                                      hcap_total - caps[c])
            reports = driver.step(T, per_w)
            # fold in cohort-id order: every total below is
            # deterministic regardless of which worker answered first
            for c in range(C):
                r = reports[c]
                caps[c] = r["cap"]
                qs[c] = r["queued_service"]
                done[c] = r["done"]
                add_pending[c] = [(t, g) for t, g in add_pending[c]
                                  if t > T]
            cap_total = sum(caps)
            if cap_total > peak_total:
                peak_total = cap_total
            cc = fold_demand_counts(reports[c]["cc"] for c in range(C))
            if cc:
                demand.append((T, cc))
                for n, v in cc.items():
                    wg_counts[n] = wg_counts.get(n, 0) + v
            pending_total = sum(g for pend in add_pending
                                for _, g in pend)
            busy_total = sum(reports[c]["busy"] for c in range(C))

            # ticks due by this barrier, interleaved in the fast lane's
            # order, evaluated on barrier-frozen fleet-wide state
            rel_issued = False
            while True:
                if next_autoscale <= next_metrics:
                    tx = next_autoscale
                    if tx > T:
                        break
                    next_autoscale += cfg.autoscale_interval_s
                    n_ticks += 1
                    if tx > max_tick_t:
                        max_tick_t = tx
                    expire = tx - cfg.horizon_s
                    while demand and demand[0][0] < expire:
                        _, counts = demand.popleft()
                        for n, v in counts.items():
                            wg_counts[n] -= v
                    plan = plan_capacity_targets(
                        cfg.policy, wg_counts, sim.planner.p,
                        sim.capacity_spec,
                        current={cls_name: cap_total},
                        horizon_s=min(cfg.horizon_s, tx),
                        headroom=cfg.headroom,
                        release_threshold=cfg.release_threshold,
                        demands=iter(()), demand_c_batch=cb_full,
                        rate_discounts=None)
                    target = plan.targets.get(cls_name, cap_total)
                    provisioned = cap_total + pending_total
                    if target > provisioned:
                        kk = target - provisioned
                        t_add = max(tx + cfg.provision_delay_s, T)
                        give = _distribute_add(
                            kk, [caps[c] + sum(g for _, g in
                                               add_pending[c])
                                 for c in range(C)])
                        for c, g in enumerate(give):
                            if g:
                                outbox[c].append((t_add, _ADD, g))
                                add_pending[c].append((t_add, g))
                        pending_total += kk
                    elif plan.release_gpus and target < cap_total:
                        # floor at fleet busy, min_gpus and C (one
                        # server per lane); applied at the NEXT chunk
                        # start (stamp T), lanes clamp by live busy
                        tgt_total = max(target, busy_total, min_gpus, C)
                        if tgt_total < cap_total:
                            slices = slice_evenly(tgt_total, C)
                            for c in range(C):
                                outbox[c].append((T, _REL, slices[c]))
                            rel_issued = True
                else:
                    tx = next_metrics
                    if tx > T:
                        break
                    next_metrics += cfg.metrics_interval_s
                    n_ticks += 1
                    if tx > max_tick_t:
                        max_tick_t = tx
                    busy_int = sum(reports[c]["busy_int"]
                                   for c in range(C))
                    cap_int = sum(reports[c]["cap_int"]
                                  for c in range(C))
                    d_busy = busy_int - last_busy_int
                    d_cap = cap_int - last_cap_int
                    last_busy_int = busy_int
                    last_cap_int = cap_int
                    committed = sum(reports[c]["committed"]
                                    for c in range(C))
                    queue_total = sum(reports[c]["queue_len"]
                                      for c in range(C))
                    win_depth = sum(reports[c]["win_depth"]
                                    for c in range(C))
                    rows.append({
                        "t": tx,
                        "arrivals": sum(reports[c]["arrivals"]
                                        for c in range(C)),
                        "completed": sum(reports[c]["completed"]
                                         for c in range(C)),
                        "in_flight": sum(reports[c]["in_flight"]
                                         for c in range(C)),
                        "violations": sum(reports[c]["violations"]
                                          for c in range(C)),
                        # barrier-granular rows: per-interval
                        # percentiles and min_slack are not folded
                        # across processes (the final merged stream
                        # carries the distribution)
                        "p50_latency": None,
                        "p99_latency": None,
                        "queue_depth": queue_total,
                        "window_depth": win_depth,
                        "gpus": cap_total,
                        "gpus_pending": pending_total,
                        "gpus_busy": busy_total,
                        "utilization": (d_busy / d_cap)
                        if d_cap > 0 else 0.0,
                        "gpu_seconds": committed,
                        "gpu_cost": committed * weight,
                        "t_lim": sim.p.t_lim,
                        "preempted_gpus": 0,
                        "killed_jobs": 0,
                        "rejected": 0,
                        "degraded": 0,
                        "replans": 0,
                        "per_class": {cls_name: {"gpus": cap_total,
                                                 "busy": busy_total,
                                                 "queue": queue_total}},
                        "min_slack": None,
                    })

            # barrier rebalancing: migrate idle servers to lanes with a
            # queue (one server per queued batch), as conserving delta
            # pairs stamped at this barrier — the sharded analogue of
            # the shared pool, with one-chunk lag.  The donor's idle
            # count is frozen-exact: events stamped T apply before any
            # post-T arrival, when lane state still equals this
            # barrier's report.  Skipped on barriers that issued
            # absolute release targets (deltas would not commute).
            if not rel_issued:
                idle = [caps[c] - reports[c]["busy"] for c in range(C)]
                donors = [c for c in range(C)
                          if reports[c]["queue_len"] == 0
                          and caps[c] > 1 and idle[c] > 0]
                di = 0
                for c in range(C):
                    need = reports[c]["queue_len"]
                    while need > 0 and di < len(donors):
                        d = donors[di]
                        # keep >= 1 server on the donor so every lane
                        # always drains
                        avail = min(idle[d], caps[d] - 1)
                        if avail <= 0:
                            di += 1
                            continue
                        take = min(avail, need)
                        outbox[d].append((T, _TAKE, take))
                        outbox[c].append((T, _ADD, take))
                        idle[d] -= take
                        caps[d] -= take
                        caps[c] += take
                        need -= take

        # trailing: flush every unsent capacity event into finalize
        per_w_fin: Dict[int, Dict] = {w: {} for w in range(P)}
        for c in range(C):
            if outbox[c]:
                outbox[c].sort()
            per_w_fin[owner[c]][c] = outbox[c]
        finals, worker_rss = driver.fin(per_w_fin)
    finally:
        driver.close()

    # -- fold final lane reports (cohort order) and write back --
    last_t = max_tick_t
    for c in range(C):
        if finals[c]["last_t"] > last_t:
            last_t = finals[c]["last_t"]
    n_arr = sum(finals[c]["arrivals"] for c in range(C))
    n_jobs = sum(finals[c]["jobs"] for c in range(C))
    n_ev = sum(finals[c]["events"] for c in range(C))
    completed_n = sum(finals[c]["completed"] for c in range(C))
    violations_n = sum(finals[c]["violations"] for c in range(C))
    committed = sum(finals[c]["committed"] for c in range(C))
    released = sum(finals[c]["released"] for c in range(C))
    cap_final = sum(finals[c]["cap"] for c in range(C))
    if cap_final > peak_total:
        peak_total = cap_final
    # each lane closed its capacity integral at its OWN last event;
    # extend every lane's final capacity to the global end of run
    cap_int_total = sum(
        finals[c]["cap_int"]
        + finals[c]["cap"] * (last_t - finals[c]["last_t"])
        for c in range(C))

    sim.n_arrivals = n_arr
    sim.n_events = n_ev + n_ticks + n_arr + n_jobs + completed_n
    sim.tracker.completed = completed_n
    sim.tracker.violations = violations_n
    sim.planner.plan_calls += n_arr
    if sim.planner.cache is not None:
        sim.planner.cache.hits += n_arr
    pl.capacity = cap_final
    pl.pending = 0
    pl.peak_capacity = peak_total
    pl.released_total = released
    pl.gpu_seconds = committed
    pl.weighted_gpu_seconds = committed * weight
    pl.busy = 0
    pl.queued_service = 0.0
    pl._busy_integral = committed
    pl._cap_integral = cap_int_total
    pl._last_t = last_t
    sim.pool.peak_capacity = peak_total
    # k-way fold: one combined-CDF step over all cohort streams (tail
    # accuracy stays at the single-estimator level however many cohorts
    # there are); cohort-id order keeps the bits P-invariant
    sim.stream = StreamingLatencyStats.merged(
        (finals[c]["stream"] for c in range(C)), kway=True)
    sim.timeseries.extend(rows)
    sim._shard_processes = P
    sim._shard_chunk_s = chunk_s
    sim._per_shard = [{
        "cohort": c,
        "arrivals": finals[c]["arrivals"],
        "events": finals[c]["events"],
        "jobs": finals[c]["jobs"],
        "completed": finals[c]["completed"],
        "violations": finals[c]["violations"],
        "gpu_seconds": finals[c]["committed"],
    } for c in range(C)]
    sim._worker_rss_mb = list(worker_rss)
    return sim._build_result(last_t)
