"""Where the time of one layer split goes: a profiler trace of the cloud
half (``LayerSplitEngine.process``) and the device half
(``LayerSplitDevice.complete``) of one batch.

``profile_round`` serves one batch through a pair of engines that have
already served it once (so nothing is warmed inside the trace) under
``torch.profiler`` and returns each side's ``gpu_seconds``, the device
time of each class of kernel (the flash-attention, RG-LRU and SSD
kernels, GEMMs, copies, the rest), the ten largest kernels, the kernel
launches the wrappers counted, and the device's idle share over the
round.  It raises if the trace holds another number of the hand kernels
than the wrappers counted.  ``chip_smoke.py`` runs it on the engines of
its ``lm_serve`` and ``mamba_serve`` phases; on the CPU there are no
device kernels and the device fields are null.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import ssd_scan as ssd

#: substrings of the kernel names of each class (lower case)
KERNEL_CLASSES = (
    ("flash_attention", ("flash_attention_kernel",)),
    ("rglru_scan", ("rglru_scan_kernel",)),
    ("ssd_scan", ("ssd_scan_kernel",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


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


def summarize_trace(events: List[dict], wall_s: float) -> Dict:
    """Device time by kernel class from Chrome-trace events (microseconds),
    and the share of ``wall_s`` in which no kernel or copy ran.  Raises if
    the device was busy for longer than ``wall_s``."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        return {"device_seconds": None, "by_class": None, "top": None,
                "kernels_in_trace": None, "idle_share": None}
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
        "kernels_in_trace": counts,
        "top": [{"name": n[:120], "calls": len(d), "seconds": sum(d)}
                for n, d in top],
        "idle_share": 1.0 - busy / wall_s,
    }


def profile_round(cloud, device, tokens: np.ndarray, group: int) -> Dict:
    """One round of ``tokens`` split at ``group`` through ``cloud`` (a
    ``LayerSplitEngine``) and ``device`` (its ``LayerSplitDevice``) under
    ``torch.profiler``; see the module's docstring for what it returns."""
    dev = device.device
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    before = {"cloud": cloud.stats["gpu_seconds"],
              "device": device.stats["gpu_seconds"]}
    misses = cloud.stats["cache_misses"] + device.stats["cache_misses"]
    launches = (fa.launch_count, lru.launch_count, ssd.launch_count)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        payload, _ = cloud.process({"tokens": tokens}, group)
        logits = device.complete(payload, group)
        wall = time.perf_counter() - t0
    launched = {"flash_attention": fa.launch_count - launches[0],
                "rglru_scan": lru.launch_count - launches[1],
                "ssd_scan": ssd.launch_count - launches[2]}
    if cloud.stats["cache_misses"] + device.stats["cache_misses"] != misses:
        raise RuntimeError("the profiled round warmed an engine up: serve "
                           "the batch once before profiling it")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {
        "batch": int(tokens.shape[0]), "seq": int(tokens.shape[1]),
        "group": group, "wall_seconds": wall,
        "side_seconds": {k: s.stats["gpu_seconds"] - before[k]
                         for k, s in (("cloud", cloud), ("device", device))},
        "wrapper_launches": launched,
        **summarize_trace(events, wall),
    }
    in_trace = out["kernels_in_trace"]
    if in_trace is not None and any(in_trace.get(k, 0) != n
                                    for k, n in launched.items()):
        raise RuntimeError(f"the trace holds {in_trace} kernels, the "
                           f"wrappers counted {launched} launches")
    return out
