"""Where the time of one layer split, or of a few decode steps, goes: a
profiler trace of the cloud half (``LayerSplitEngine.process``) and the
device half (``LayerSplitDevice.complete``) of one batch, or of
``transformer.decode_step``.

``profile_round`` serves one batch through a pair of engines that have
already served it once (so nothing is warmed inside the trace) under
``torch.profiler`` and returns each side's ``gpu_seconds``, the device
time of each class of kernel (the flash-attention, decode-attention,
RG-LRU and SSD kernels, GEMMs, copies, the rest), the ten largest
kernels, the wrappers' calls and the CUDA kernels those enqueued, and
the device time launched inside each ``record_function`` scope of
``SCOPES`` (the MoE layers' dispatch and experts), and the device's
idle share over the round.  ``profile_decode`` does the
same for decode steps through a warm cache.  Both trace through
``traced``, whose first kernels absorb the records CUPTI drops at the
start of a session.  Both raise if the trace
lacks a class of hand kernel the wrappers enqueued, holds more of it, or
lacks more than one record in a hundred of it (``_check_trace``).
``chip_smoke.py`` runs them in its ``lm_serve``, ``mamba_serve``,
``moe_serve``, ``lm_decode``, ``mamba_decode``, ``moe_decode`` and
``decode_profile`` phases; on the CPU
there are no device kernels and the device fields are null.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer as tr

#: substrings of the kernel names of each class (lower case)
KERNEL_CLASSES = (
    ("flash_attention", ("flash_attention_kernel",)),
    ("decode_attention", ("decode_split_kernel", "decode_merge_kernel")),
    ("rglru_scan", ("rglru_scan_kernel",)),
    ("ssd_scan", ("ssd_",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


#: the ``record_function`` scopes of the model code whose device time a
#: trace reports (``models/moe.py``); a kernel counts for the innermost
#: scope its launch lies in
SCOPES = ("moe_dispatch", "moe_experts")


#: the hand kernels' wrappers, by class
WRAPPERS = {"flash_attention": fa, "decode_attention": dec,
            "rglru_scan": lru, "ssd_scan": ssd}
#: CUDA kernels one wrapper call launches, where that is fixed (decode:
#: split, then merge); the SSD wrapper counts what it enqueues (one kernel
#: for a decode step, three phases for longer) in its ``kernel_count``
KERNELS_PER_CALL = {"decode_attention": 2}


def wrapper_counts() -> Dict[str, int]:
    """The wrappers' launch counts, by class."""
    return {n: m.launch_count for n, m in WRAPPERS.items()}


def kernel_counts() -> Dict[str, int]:
    """The CUDA kernels the wrappers enqueued, by class."""
    return {n: getattr(m, "kernel_count",
                       m.launch_count * KERNELS_PER_CALL.get(n, 1))
            for n, m in WRAPPERS.items()}


def _since(before: Dict[str, int], now: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in now.items()}


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _busy_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _scope_of(events: List[dict], names) -> Callable[[dict], str]:
    """A function from a device event (kernel, copy) to the innermost span
    of ``names`` (same host thread) that holds its launch, the runtime or
    driver call of the same correlation id; None where no span does."""
    spans = [(e["ts"], e["ts"] + e["dur"], e.get("tid"), e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] in names]
    launched = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def scope(e: dict):
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is None:
            return None
        inside = [s for s in spans if s[2] == at[1] and s[0] <= at[0] <= s[1]]
        return min(inside, key=lambda s: s[1] - s[0])[3] if inside else None
    return scope


def time_by_scope(events: List[dict], device: List[dict]) -> Dict:
    """Device seconds of the ``device`` events whose launch lies inside a
    ``SCOPES`` span; the innermost span takes it (``_scope_of``)."""
    scope = _scope_of(events, SCOPES)
    out = dict.fromkeys(SCOPES, 0.0)
    for e in device:
        name = scope(e)
        if name is not None:
            out[name] += e["dur"] * 1e-6
    return out


def summarize_trace(events: List[dict], wall_s: float) -> Dict:
    """Device time by kernel class from Chrome-trace events (microseconds),
    and the share of ``wall_s`` in which no kernel or copy ran.  Raises if
    the device was busy for longer than ``wall_s``.  The kernels launched
    inside the ``WARMUP_SCOPE`` span (``traced``) are left out, and
    counted in ``warmup_kernels_in_trace``."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    warm = _scope_of(events, (WARMUP_SCOPE,))
    n_device = len(device)
    device = [e for e in device if warm(e) is None]
    if not device:
        return {"device_seconds": None, "by_class": None, "by_scope": None,
                "top": None, "kernels_in_trace": None, "idle_share": None,
                "warmup_kernels_in_trace": None}
    by_class: Dict[str, float] = {}
    per_name: Dict[str, List[float]] = {}
    counts: Dict[str, int] = {}
    for e in device:
        cls = ("copy" if e["cat"] != "kernel" else kernel_class(e["name"]))
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] * 1e-6
        counts[cls] = counts.get(cls, 0) + 1
        per_name.setdefault(e["name"], []).append(e["dur"] * 1e-6)
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) * 1e-6
    if busy > wall_s:
        raise RuntimeError(f"the device was busy {busy} s in a round of "
                           f"{wall_s} s on the host clock")
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {
        "device_seconds": sum(by_class.values()),
        "busy_seconds": busy,
        "by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "by_scope": time_by_scope(events, device),
        "kernels_in_trace": counts,
        "top": [{"name": n[:120], "calls": len(d), "seconds": sum(d)}
                for n, d in top],
        "idle_share": 1.0 - busy / wall_s,
        "warmup_kernels_in_trace": n_device - len(device),
    }


def _trace_events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


#: tiny kernels ``traced`` launches first in every window on a GPU, in a
#: span of this name: CUPTI drops the first records of a
#: ``torch.profiler`` session, more of them the more sessions the process
#: has run (a whole-model decode round on an H100 has lost 49, two of them
#: decode attention's), so these take the loss and the summary leaves
#: them out
WARMUP_SCOPE = "trace_warmup"
TRACE_WARMUP_KERNELS = 512
#: host seconds a window stays open after the block's synchronise, so that
#: a kernel whose timestamp, moved onto the host's clock, lands late still
#: falls inside it
TRACE_TAIL_SECONDS = 0.05


@contextlib.contextmanager
def traced(dev: torch.device) -> Iterator[torch.profiler.profile]:
    """``torch.profiler.profile`` of the host and, on a GPU, of the
    device around the block: the device synchronised first, the
    ``WARMUP_SCOPE`` kernels launched and waited for before the block,
    the window held ``TRACE_TAIL_SECONDS`` after it.  The block ends in
    a synchronise of its own where its wall time is to hold the
    device's work."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = dev.type == "cuda"
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            with torch.profiler.record_function(WARMUP_SCOPE):
                x = torch.zeros(1, device=dev)
                for _ in range(TRACE_WARMUP_KERNELS - 1):
                    x.add_(1)
            torch.cuda.synchronize(dev)
        yield prof
        if cuda:
            torch.cuda.synchronize(dev)
            time.sleep(TRACE_TAIL_SECONDS)


#: the share of a class of hand kernels a trace may lack before the check
#: below refuses it: CUPTI has been seen to drop one kernel record of 192
#: (an SSD decode step), so one record is always let through
TRACE_LOSS_SHARE = 0.01


def _check_trace(out: Dict) -> Dict:
    """Hold the trace's hand kernels to what the wrappers enqueued, class
    by class, and record each class's shortfall in ``out["trace_lost"]``.
    Raise if a class that was enqueued is absent from the trace, if the
    trace holds more of a class than was enqueued, or if it lacks more
    than ``max(1, TRACE_LOSS_SHARE * enqueued)`` of one (the profiler,
    not the port, loses the odd record).  The wrappers' own counts are
    held exactly by their callers."""
    in_trace, enqueued = out["kernels_in_trace"], out["wrapper_kernels"]
    lost = {}
    if in_trace is not None:
        for cls, n in enqueued.items():
            got = in_trace.get(cls, 0)
            allowed = max(1, int(TRACE_LOSS_SHARE * n))
            if (n and not got) or got > n or n - got > allowed:
                raise RuntimeError(
                    f"the trace holds {in_trace} kernels, the wrappers "
                    f"enqueued {enqueued} ({cls}: at most {allowed} may be "
                    f"missing)")
            lost[cls] = n - got
    out["trace_lost"] = lost if in_trace is not None else None
    return out


def profile_round(cloud, device, tokens: np.ndarray, group: int) -> Dict:
    """One round of ``tokens`` split at ``group`` through ``cloud`` (a
    ``LayerSplitEngine``) and ``device`` (its ``LayerSplitDevice``) under
    ``torch.profiler``; see the module's docstring for what it returns."""
    dev = device.device
    before = {"cloud": cloud.stats["gpu_seconds"],
              "device": device.stats["gpu_seconds"]}
    misses = cloud.stats["cache_misses"] + device.stats["cache_misses"]
    counts, kernels = wrapper_counts(), kernel_counts()
    with traced(dev) as prof:
        t0 = time.perf_counter()
        payload, _ = cloud.process({"tokens": tokens}, group)
        logits = device.complete(payload, group)
        wall = time.perf_counter() - t0
    if cloud.stats["cache_misses"] + device.stats["cache_misses"] != misses:
        raise RuntimeError("the profiled round warmed an engine up: serve "
                           "the batch once before profiling it")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    return _check_trace({
        "batch": int(tokens.shape[0]), "seq": int(tokens.shape[1]),
        "group": group, "wall_seconds": wall,
        "side_seconds": {k: s.stats["gpu_seconds"] - before[k]
                         for k, s in (("cloud", cloud), ("device", device))},
        "wrapper_launches": _since(counts, wrapper_counts()),
        "wrapper_kernels": _since(kernels, kernel_counts()),
        **summarize_trace(_trace_events(prof), wall),
    })


def profile_decode(params, cfg, tokens: torch.Tensor, cache, start: int,
                   steps: int) -> Dict:
    """``steps`` teacher-forced ``decode_step``s under ``torch.profiler``:
    token ``tokens[:, start + t]`` at position ``start + t``, through
    ``cache`` (updated in place; it needs rows up to ``start + steps``).
    The round ends in a synchronise, so its wall time holds the device's
    work.  Returns the summary of ``profile_round`` with ``steps`` and the
    host's milliseconds a step in place of the sides' seconds."""
    dev = params["embed"].device
    counts, kernels = wrapper_counts(), kernel_counts()
    with traced(dev) as prof:
        t0 = time.perf_counter()
        for t in range(start, start + steps):
            logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache,
                                           t, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    return _check_trace({
        "batch": int(tokens.shape[0]), "start": start, "steps": steps,
        "wall_seconds": wall, "step_ms_host": wall / steps * 1e3,
        "wrapper_launches": _since(counts, wrapper_counts()),
        "wrapper_kernels": _since(kernels, kernel_counts()),
        **summarize_trace(_trace_events(prof), wall),
    })
