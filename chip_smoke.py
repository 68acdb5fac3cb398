#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and holds each against its plain PyTorch version on the card.  Then it
drives the port's serving paths, each at full published width:

  * diffusion (Stable-Diffusion-v1): a split-serving engine answers 8
    requests with int8 boundary payloads, each group's latent and context
    quantised in one launch (phase ``kernels`` holds the kernel to its
    plain version first), and the device side completes one request of
    each group;
  * the paper's scheduler end to end (phase ``replay``): the fleet
    simulator records the golden workload's decision trace, every plan is
    re-derived from it, and its first 12 dispatch records run through a
    fresh full-width diffusion engine on the serve's weights; executables,
    cache hit rate and int8 payload bytes are reconciled with the model's,
    one int8 launch a dispatch;
  * layer split (RecurrentGemma-9B, 38 layers, bf16): the cloud engine
    runs groups [0, g) of 4 requests of 4096 tokens at g = 6 and of one
    request at g = 0 and g = 12, ships the fp16 hidden state, and the
    device side finishes each; the flash-attention and RG-LRU kernels
    carry every attention and recurrent layer.  One more g = 6 round then
    runs under ``torch.profiler`` (phase ``lm_profile``): device time by
    kernel class and the device's idle share;
    Request 0 is then prefilled and decoded 16 steps (phase
    ``lm_decode``): decode attention over a window inside a longer cache,
    the RG-LRU kernel at one step;
  * the same layer split on Mamba-2-780M (48 SSD layers, bf16), after
    RecurrentGemma's weights are freed: the SSD kernel is held against its
    plain version and timed at batch 4 and batch 1 (phase
    ``ssd_kernels``), then 4 requests of 4096 tokens
    are split at g = 24 and request 0 at g = 0 and g = 48, with the SSD
    kernel in every layer, and one more g = 24 round is profiled (phase
    ``mamba_serve``); request 0 is decoded 16 steps (``mamba_decode``);
  * decode (Qwen2-7B, 28 attention layers, bf16), after Mamba-2's weights
    are freed: the decode-attention kernel is held against its plain
    version and timed at Qwen2-7B's and RecurrentGemma-9B's decode shapes
    (phase ``decode_kernels``), then 8 sequences of 4096 tokens
    are prefilled through the flash kernel and decoded 64 teacher-forced
    steps through a 4160-row cache, every layer's attention through the
    decode kernel; fp32 and int8-cache decodes are held to a one-machine
    forward and to the plain version (``decode_serve``), and 8 more steps
    are profiled (``decode_profile``).
  * RegNet-Y-128GF, the paper's classifier (phase ``regnet``), after
    Qwen2-7B's weights are freed: one 384 x 384 image through the forward
    and split at each point of paper Table 1, the activation through the
    host, held to the forward; its segments and forward timed at batch 1
    and 8.

Each phase prints one JSON line (``total``: the script's own time, the
kernels' build included).  The line before the last two is
``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises: the exit code
is then non-zero and no result line is printed.  There is no CPU mode.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): the bounds below
# are stated against these, whatever the card's power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

MAIN_PATH_SHAPES = ((4, 4096), (2, 59136))     # latent, context per request
RAGGED_SHAPES = ((509, 256), (1, 8), (130, 64))
# int8 groups of the diffusion serve (requests, with the context): the
# serve's end group is 7 requests without it
INT8_GROUPS = ((1, True), (3, True), (8, True), (7, False))
N_REQUESTS = 8
SEED = 0
# Images lie in [-1, 1]; the split run and the one-machine run do the same
# fp32 arithmetic on the same card, so they should agree far inside this.
SPLIT_ATOL = 1e-3

# The paper's scheduler end to end: the golden fleet-sim workload of the
# reference's engine-replay bench (benchmarks/engine_replay.py FULL_CELL),
# its decision trace re-derived (490 plans, no replans), and its first
# dispatch records (the bench's smoke cap) through a fresh full-width
# engine on the card.
REPLAY_CELL = dict(seed=7, rate=12.0, duration=40.0, gpus_init=10,
                   max_gpus=32, metrics_interval_s=10.0)
REPLAY_PLANS = 490
REPLAY_RECORDS = 12

# RegNet-Y-128GF, the paper's classifier, uncut: its parameters as the
# reference's jax.eval_shape counts them, the activation bytes at each
# split point of paper Table 1 (batch 1, 384 x 384, fp32), and the
# floating-point operations of one image through the reference's forward
# as XLA's cost_analysis counts them (a count, not a time).
REGNET_PARAMETERS = 644_733_224
REGNET_PARAMETER_BYTES = 2_578_932_896
REGNET_TABLE1_BYTES = {"stem": 4_718_592, "block1": 19_464_192,
                       "block2": 9_732_096, "block3": 6_690_816,
                       "block4": 4_257_792, "avgpool": 29_568}
REGNET_FLOPS_PER_IMAGE = 739_913_170_944
REGNET_BATCHES = (1, 8)
# The split runs the same fp32 convolutions on the same card as forward,
# with an exact copy through the host between its halves: summation order
# is all that may differ, far inside this share of the largest logit.
REGNET_SPLIT_RTOL = 1e-5

# The layer-split path: full-width RecurrentGemma-9B, uncut.
LM_ARCH = "recurrentgemma-9b"
LM_BATCH, LM_SEQ = 4, 4096
# jax.eval_shape of the reference's init_params for this config (the
# analytic ModelConfig.param_count() says 5,915,025,408)
LM_PARAMETERS = 7_714_385_920
LM_PARAMETER_BYTES = 15_430_041_600
# the reference's fp16-boundary tolerance (tests/test_serving.py)
LM_SPLIT_ATOL, LM_SPLIT_RTOL = 0.15, 0.1
# kernels against plain versions over the whole 38-layer forward, as the
# relative L2 error of the last-token logits.  The check that can see a
# kernel's fault runs in fp32 (every parameter cast to fp32, request 0),
# where both kernels agree with their plain versions to a few 1e-6 and
# nothing is rounded to bf16 between layers.  Measured 5.5e-6 on an H100
# (PERF.md); the limit is about nine times that
LM_FP32_PLAIN_REL_L2 = 5e-5
# The bf16 forward as served (4 requests) is held to its plain versions
# too, but that distance is rounding noise: any difference in the last
# bits flips some bf16 roundings, which 38 layers of random bf16 weights
# carry to ~2 % of the logits (PERF.md: the scan alone, 3.8e-6 from its
# plain version, moves them 1.98e-2).  So it gets a loose limit, and the
# bf16 forward through the kernels may lie at most LM_FP32_RATIO times
# as far from the fp32 forward as the one through the plain versions.
LM_PLAIN_REL_L2 = 3e-2
LM_FP32_RATIO = 1.5
# the reference's kernel grids (tests/test_kernels.py) and tolerances
FLASH_GRID = (
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 8, 128, True, 0),
    (2, 256, 256, 4, 1, 80, True, 64),
    (1, 128, 128, 2, 2, 128, False, 0),
    (1, 512, 512, 3, 3, 64, True, 128),
)
# ragged tails the kernel masks by bounds (no tile divides these lengths),
# d = 16, a kv_len below Skv, and d = 36 (rows of 72 bytes: 8-byte
# copies) with every mask at once: (case, kv_len)
FLASH_RAGGED = (
    ((2, 100, 100, 4, 1, 16, True, 32), None),
    ((1, 77, 203, 6, 2, 32, False, 0), 150),
    ((1, 97, 150, 3, 1, 36, True, 24), 121),
)
# (atol, rtol).  fp32 as tests/test_kernels.py holds the Pallas kernel.
# In bf16 kernel and plain version both accumulate in fp32 and round the
# output once, so they differ by at most one bf16 step (2^-7 relative) of
# the output: rtol 2e-2 covers that, and atol 2e-3 is set against the
# path's outputs (std ~0.04 where a query sees 2048 keys), not against 1
FLASH_TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-3, 2e-2)}
RGLRU_GRID = ((2, 128, 256), (1, 512, 128), (3, 96, 200))
RGLRU_ATOL = 2e-5

# The layer-split path's attention-free model: full-width Mamba-2-780M,
# uncut (48 SSD layers, no tail), split at its middle group.
SSD_ARCH = "mamba2-780m"
SSD_SPLIT = 24
# jax.eval_shape of the reference's init_params for this config (the
# analytic ModelConfig.param_count() says 857,070,336)
SSD_PARAMETERS = 860_045_568
SSD_PARAMETER_BYTES = 1_720_550_400
# the fp32 forward of request 0 (every parameter cast to fp32), through
# the SSD kernel against the same forward through its plain version, as
# the relative L2 error of the last-token logits
SSD_FP32_PLAIN_REL_L2 = 1e-4
# the reference's kernel grid (b, S, H, P, G, N, chunk_size), with
# init_state, then one chunk holding the whole sequence (Q == S, the chunk
# size above S); tolerances as tests/test_kernels.py holds the Pallas
# kernel, inputs drawn as it draws them
SSD_GRID = ((1, 256, 4, 64, 1, 128, 128), (2, 128, 8, 64, 2, 64, 64),
            (1, 512, 2, 32, 1, 16, 128), (2, 256, 8, 64, 2, 64, 512))
SSD_Y_ATOL, SSD_FINAL_ATOL = 2e-4, 2e-5
# single-chunk calls, each with and without init_state: one decode step of
# Mamba-2-780M's heads at its chunk of 256 (the step kernel, also held to
# the three phases to the bit), and the grid's Q == S case (the three
# phases, one chunk)
SSD_ONE_CHUNK = ((1, 1, 48, 64, 1, 128, 256), (2, 256, 8, 64, 2, 64, 512))

# Decode of the two layer-split models above: request 0's prompt, then
# teacher-forced steps on tokens drawn from SEED + 1, through a linear
# cache of LM_SEQ + LM_DECODE_STEPS rows.  Held to a one-machine fp32
# forward over the same tokens as the relative L2 error of the logits.
LM_DECODE_STEPS = 16
# of which the last are decoded once more under the profiler
MODEL_PROFILE_STEPS = 4
DECODE_FP32_REL_L2 = 1e-4

# The decode path: full-width Qwen2-7B, uncut (28 attention layers, 28
# query heads on 4 kv heads, head_dim 128).
DECODE_ARCH = "qwen2-7b"
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 8, 4096, 64
DECODE_LEN = DECODE_PROMPT + DECODE_STEPS
# jax.eval_shape of the reference's init_params for this config, and of
# its init_decode_cache(cfg, 8, 4160): 28 layers of bf16 k and v
DECODE_PARAMETERS = 7_626_626_560
DECODE_PARAMETER_BYTES = 15_253_919_744
DECODE_CACHE_BYTES = 1_908_408_320
# request 0 in fp32 through this many steps (the check that can see a
# routing or kernel fault), an int8 cache from empty through as many, and
# this many more steps profiled
DECODE_FP32_STEPS = DECODE_INT8_STEPS = 16
DECODE_PROFILE_STEPS = 8
# the reference's grid (tests/test_kernels.py; ragged lengths), Qwen2-7B's
# group of 7 at head_dim 128 and RecurrentGemma-9B's 16 at 256:
# (B, Skv, Hq, Hkv, D)
DECODE_GRID = ((4, 512, 8, 2, 64), (2, 384, 4, 4, 128), (3, 512, 16, 1, 80),
               (2, 1000, 28, 4, 128), (1, 2100, 16, 1, 256))
# the path's shape: q (8, 1, 28, 128), the cache (8, 4160, 4, 128), every
# sequence at 4096 valid keys (the first decode step's 4097, rounded)
DECODE_PATH = (DECODE_BATCH, DECODE_LEN, 28, 4, 128)
DECODE_PATH_LENGTH = DECODE_PROMPT
# (atol, rtol): fp32 as tests/test_kernels.py holds the Pallas kernel;
# bf16 as the flash kernel (one bf16 step of the output)
DECODE_TOL = {torch.float32: (5e-6, 0.0), torch.bfloat16: (2e-3, 2e-2)}
# calls in each CUDA-event sample of decode attention, so that a sample of
# the ~15 us C entry at the RecurrentGemma-9B shape lasts over 1 ms
DECODE_TIMING_CALLS = 100
# RecurrentGemma-9B's decode attention at lm_decode's first step: the
# 2048-key window [position - 2047, position] of a 4112-row cache, read in
# place, at position 4096
RG_DECODE_CACHE = LM_SEQ + LM_DECODE_STEPS
RG_DECODE_VIEW = (LM_SEQ - 2047, LM_SEQ + 1)
# The kernels' times before their redesign, printed beside the new ones
# in the ssd_kernels and decode_kernels lines (never in the kernels line,
# which holds only this run's measurements): the parent tree's kernels,
# this script's phases (run P18-0 in PERF.md, NVIDIA H100 80GB HBM3,
# 700 W); ms of the wrapper and of the C entry alone (decode), or of a
# wrapper call (SSD)
DECODE_BEFORE_MS = {
    "path": {"ms": 0.14776480197906494, "raw_launch_ms": 0.14580560326576233},
    "rg_shape": {"ms": 0.11321839690208435,
                 "raw_launch_ms": 0.11024159789085389}}
SSD_BEFORE_MS = {"path": 8.187647819519043, "batch_1": 4.073232173919678}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def tool_output(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_env() -> str:
    from repro_torch.kernels import _build
    smi = tool_output(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]).splitlines()[0].strip()
    nvcc = tool_output([_build.find_nvcc(), "--version"])
    release = next((ln.split("release", 1)[1].strip()
                    for ln in nvcc.splitlines() if "release" in ln), nvcc)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         nvcc_release=release,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def ptxas_report(log: str, needle: str) -> list:
    """Registers, spills and static shared memory of each kernel whose
    (mangled) name holds ``needle``, from ptxas' ``-v`` report."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": m.group(1)} if needle in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m[1])
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build
    info = _build.build_library()
    _build.load_library()
    keep = ("registers", "spill", "Compiling entry")
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if any(k in ln for k in keep)]
    flash = ptxas_report(info.log, "flash_attention")
    # every kernel of the sources this script's decode, SSD and int8
    # phases hold to their plain versions (the file's name is in each
    # mangled name)
    decode = ptxas_report(info.log, "decode_attention_cu")
    ssd = ptxas_report(info.log, "ssd_scan_cu")
    int8 = ptxas_report(info.log, "int8_quant_cu")
    occupancy = flash_occupancy()
    decode_occ = decode_occupancy()
    emit("build", seconds=info.seconds, compiled=info.compiled,
         sources=info.sources, ptxas=ptxas, flash_ptxas=flash,
         flash_occupancy=occupancy, decode_ptxas=decode,
         decode_occupancy=decode_occ, ssd_ptxas=ssd, int8_ptxas=int8)
    if not info.compiled:
        raise RuntimeError("the kernel library was not built in this run")
    for name, report, count in (("flash", flash, 6), ("decode", decode, 7),
                                ("ssd", ssd, 4), ("int8", int8, 2)):
        if len(report) != count or any(f.get("spill_store_bytes", 1)
                                       or f.get("spill_load_bytes", 1)
                                       for f in report):
            raise RuntimeError(f"{name}: {count} kernels without spills "
                               f"expected, ptxas reports {report}")
    at256 = [o for o in occupancy if (o["head_dim"], o["dtype"]) == (
        256, "bf16")]
    if at256[0]["warps_per_sm"] < 8:
        raise RuntimeError(f"flash bf16 at d = 256: {at256} (fewer than 8 "
                           "resident warps an SM)")


def flash_occupancy() -> list:
    """Shared memory, threads and resident blocks an SM of the flash
    launch at the top of each head-dim class, as the card reports them."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load_library()
    out = []
    for d in (64, 128, 256):
        for code, name in ((1, "bf16"), (0, "fp32")):
            smem, blocks, threads = (ctypes.c_int() for _ in range(3))
            _build.check_launch(lib, lib.repro_flash_attention_occupancy(
                d, code, ctypes.byref(smem), ctypes.byref(blocks),
                ctypes.byref(threads)), "flash_attention occupancy")
            out.append({"head_dim": d, "dtype": name,
                        "smem_bytes": smem.value, "threads": threads.value,
                        "blocks_per_sm": blocks.value,
                        "warps_per_sm": blocks.value * threads.value // 32})
    return out


def decode_occupancy() -> list:
    """Shared memory, threads and resident blocks an SM of the bf16
    decode split kernel at the top of each head-dim class."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load_library()
    out = []
    for d in (64, 128, 256):
        smem, blocks, threads = (ctypes.c_int() for _ in range(3))
        _build.check_launch(lib, lib.repro_decode_attention_occupancy(
            d, ctypes.byref(smem), ctypes.byref(blocks),
            ctypes.byref(threads)), "decode_attention occupancy")
        out.append({"head_dim": d, "dtype": "bf16",
                    "smem_bytes": smem.value, "threads": threads.value,
                    "blocks_per_sm": blocks.value,
                    "warps_per_sm": blocks.value * threads.value // 32})
    return out


def make_input(shape, gen) -> torch.Tensor:
    """Seeded input with the awkward rows: row 0 all zeros (when there is
    more than one row), the last row scaled so that s == 1 exactly and
    filled with exact .5 ties."""
    T, d = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 3.0
    if T > 1:
        x[0].zero_()
    ties = (torch.arange(d, device="cuda", dtype=torch.float32) % 250
            - 125.0) + 0.5
    ties[0] = 127.0
    x[T - 1] = ties
    return x.contiguous()


def time_ms(fn, inner: int = 50, samples: int = 20) -> float:
    """Median over ``samples`` of (CUDA-event time of ``inner`` calls) /
    ``inner``, after a warm-up."""
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def int8_bound(shapes):
    """Least time for one quantisation of each shape: the larger of bytes
    moved (fp32 in, int8 out, one fp32 scale a row) over the memory rate
    and operations (abs, max, divide, round, two clamps an element) over
    the fp32 rate."""
    nbytes = sum(T * d * 5 + T * 4 for T, d in shapes)
    flops = sum(T * d * 6 for T, d in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def group_shapes(B: int, with_ctx: bool = True) -> list:
    """The int8 segments of a group of B requests: its latent rows, and
    its context rows where it ends before the last iteration."""
    return [(T * B, d) for T, d in MAIN_PATH_SHAPES[:2 if with_ctx else 1]]


def check_int8(name, x, q, s, checks: list) -> float:
    """Hold one segment's kernel output to the plain version (codes
    equal, scales within one ulp), to numpy on the host (equal) and the
    ties row to even; returns the largest difference."""
    from repro_torch.kernels import int8_quant
    q_ref, s_ref = int8_quant.int8_quantize_ref(x)
    q_err = int((q.int() - q_ref.int()).abs().max())
    # distance in units in the last place: positive fp32 values order
    # like their bit patterns
    s_ulp = int((s.view(torch.int32) - s_ref.view(torch.int32))
                .abs().max())
    s_err = float((s - s_ref).abs().max())
    x_np = x.cpu().numpy()
    s_np = np.maximum(np.abs(x_np).max(1, keepdims=True)
                      / np.float32(127.0), np.float32(1e-12))
    q_np = np.clip(np.round(x_np / s_np), -127, 127).astype(np.int8)
    host_equal = bool(np.array_equal(q.cpu().numpy(), q_np)
                      and np.array_equal(s.cpu().numpy(), s_np))
    checks.append({"check": name, "shape": list(x.shape),
                   "q_max_abs_err": q_err, "s_ulp": s_ulp,
                   "equal_to_numpy": host_equal})
    if q.shape != x.shape or s.shape != (x.shape[0], 1):
        raise RuntimeError(f"int8 {name}: wrong output shapes")
    if q_err != 0 or s_ulp > 1:
        raise RuntimeError(
            f"int8 {name} disagrees with its plain version: "
            f"max|dq|={q_err}, scales differ by {s_ulp} ulp")
    if not host_equal:
        raise RuntimeError(f"int8 {name} disagrees with numpy on the host")
    return max(float(q_err), s_err)


def int8_group_cases(gen) -> list:
    """(name, segments) of the grouped checks: groups of 1, 3 and 8
    requests at full width, a ragged mix, rows that start off 16 bytes,
    and rows whose max sits in the last block's slice (and in a ragged
    tail, d % 4 = 1)."""
    cases = [(f"group of {B}", [make_input(sh, gen)
                                for sh in group_shapes(B)])
             for B, _ in INT8_GROUPS[:3]]
    cases.append(("ragged mix", [make_input(sh, gen) for sh in
                                 RAGGED_SHAPES + ((3, 333), (7, 1024))]))
    base = torch.randn(3 * 4096 + 2 * 59136 + 2, generator=gen,
                       device="cuda")
    cases.append(("misaligned starts", [
        base[1:1 + 3 * 4096].view(3, 4096),
        base[2 + 3 * 4096:].view(2, 59136)]))
    last = torch.randn((2, 59136), generator=gen, device="cuda") * 0.01
    last[:, -1] = torch.tensor([40.0, -75.5], device="cuda")
    tail = torch.randn((2, 59137), generator=gen, device="cuda") * 0.01
    tail[:, -1] = torch.tensor([-9.0, 33.0], device="cuda")
    cases.append(("max in the last block", [last, tail]))
    return cases


def phase_kernels() -> dict:
    from quant_ab import group_c_entry, traced
    from repro_torch.kernels import _build, int8_quant
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    checks = []
    inputs = {}
    for shape in MAIN_PATH_SHAPES + RAGGED_SHAPES:
        x = make_input(shape, gen)
        inputs[shape] = x
        q, s = int8_quant.int8_quantize(x)
        torch.cuda.synchronize()
        max_err = max(max_err, check_int8("int8_quantize", x, q, s, checks))
        if ties_row_wrong(q, x):
            raise RuntimeError(f"int8_quantize{shape}: ties not to even")
    for name, segs in int8_group_cases(gen):
        shapes = [tuple(x.shape) for x in segs]
        buf = int8_quant.int8_quantize_group(segs)
        torch.cuda.synchronize()
        for x, (q, s) in zip(segs, int8_quant.split_group(buf, shapes)):
            max_err = max(max_err, check_int8(name, x, q, s, checks))

    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def c_entry(segs, buf):
        """The C entry alone, its table and output made beforehand."""
        return group_c_entry(lib, int8_quant, segs, buf, stream)

    per_shape = []
    for sh in MAIN_PATH_SHAPES:
        b_ms, _, nbytes = int8_bound([sh])
        x = inputs[sh]
        per_shape.append({
            "shape": list(sh), "bytes": nbytes, "bound_ms": b_ms,
            "ms": time_ms(lambda: int8_quant.int8_quantize(x)),
            "raw_launch_ms": time_ms(c_entry(
                [x], int8_quant.int8_quantize_group([x]))),
            "plain_ms": time_ms(lambda: int8_quant.int8_quantize_ref(x))})
    per_group = []
    for B, with_ctx in INT8_GROUPS:
        shapes = group_shapes(B, with_ctx)
        # values like the serve's: no zero row, whose quotients 0 / 1e-12
        # take the slow path of an IEEE divide
        segs = [torch.randn(sh, generator=gen, device="cuda") * 3.0
                for sh in shapes]
        b_ms, b_by, nbytes = int8_bound(shapes)
        rows, max_d = sum(T for T, _ in shapes), max(d for _, d in shapes)

        def kernel():
            return int8_quant.int8_quantize_group(segs)

        def plain():
            return int8_quant.int8_quantize_group_ref(segs)

        def empty():
            return lib.repro_int8_empty_launch(rows, max_d, stream)
        _build.check_launch(lib, empty(), "int8 empty launch")
        # kernel and plain version in turns, on this one card
        plain_a, kern_a = time_ms(plain), time_ms(kernel)
        kern_b, plain_b = time_ms(kernel), time_ms(plain)
        before = int8_quant.launch_count
        trace = traced(torch, kernel, 20)
        if int8_quant.launch_count - before != 21:
            raise RuntimeError(f"a group of {B} took more than one launch")
        floor = traced(torch, empty, 20)
        per_group.append({
            "requests": B, "context": with_ctx, "shapes": shapes,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "raw_launch_ms": time_ms(c_entry(segs, kernel())),
            "device_us": trace["int8_us"],
            "kernels_in_trace": trace["int8_launches"],
            "empty_launch": {"raw_launch_ms": time_ms(empty),
                             "device_us": floor["empty_us"]}})
    one = per_group[0]
    entry = {
        "name": "int8_quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
        "replaces": "src/repro/kernels/int8_quant.py:30",
        "launches": None,                      # filled in by the serve phase
        "max_abs_err": max_err,
        # one request's boundary, the latent and the context, in one launch
        "ms": one["ms"], "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "library_ms": None,
        "timed": "int8_quantize_group, latent (4,4096) + context (2,59136), "
                 "inputs warm in L2; median of 20 x 50 calls, best of 2",
        "per_shape": per_shape, "per_group": per_group,
    }
    emit("kernels", checks=checks, int8_quantize=entry)
    return entry


def ties_row_wrong(q: torch.Tensor, x: torch.Tensor) -> bool:
    """The last row holds k + 0.5 with s == 1: every code must be the even
    neighbour."""
    row = x[-1, 1:]
    want = torch.where(torch.floor(row) % 2 == 0, torch.floor(row),
                       torch.ceil(row)).clamp(-127, 127).to(torch.int8)
    return not torch.equal(q[-1, 1:], want)


def phase_serve(kernel_entry: dict):
    from repro_torch.configs import stable_diffusion_v1
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.telemetry import generate_fleet
    from repro_torch.core.transport import WAN_LINK, wire_nbytes
    from repro_torch.kernels import int8_quant
    from repro_torch.models import diffusion
    from repro_torch.serving.engine import DiffusionSplitEngine, Request

    cfg = stable_diffusion_v1.CONFIG
    t0 = time.perf_counter()
    params = diffusion.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in diffusion.DiffusionModel(
        params, cfg).parameters())
    cost = CostParams(r_cloud=40.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=3.0, k_decode=1.0)
    link = WAN_LINK
    engine = DiffusionSplitEngine(params, cfg, cost, link=link, wire="int8",
                                  device="cuda")
    fleet = generate_fleet(N_REQUESTS, 2.25, 0.8, seed=SEED, rtt=link.rtt)
    rng = np.random.default_rng(SEED)
    reqs = [Request(d.device_id, d,
                    rng.integers(0, cfg.text_vocab, (1, cfg.text_len),
                                 dtype=np.int32),
                    np.zeros((1, cfg.text_len), np.int32)) for d in fleet]

    # the engine's int8 encoding of each group, timed on the host, and its
    # fp32 boundary kept on the card for the checks after the serve
    encoded = []
    encode_group = engine._encode_int8_group

    def timed_encode(lat, ctx2, fmt):
        t0 = time.perf_counter()
        payloads = encode_group(lat, ctx2, fmt)
        encoded.append({"seconds": time.perf_counter() - t0, "lat": lat,
                        "ctx2": ctx2, "payloads": payloads})
        return payloads
    engine._encode_int8_group = timed_encode

    torch.cuda.reset_peak_memory_stats()
    int8_quant.launch_count = 0
    t0 = time.perf_counter()
    results = engine.serve(reqs, seed=SEED)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = int8_quant.launch_count
    del engine._encode_int8_group

    n_total = cfg.n_total_iterations
    groups = {}
    for r in reqs:
        groups.setdefault(results[r.request_id].n_cloud, []).append(r)
    if len(groups) < 2 or not any(0 < n < n_total for n in groups):
        raise RuntimeError(f"fleet gave split groups {sorted(groups)}: need "
                           f"two groups and one with 0 < n_cloud < {n_total}")
    shapes_mid = {"latent": (cfg.latent_channels, cfg.latent_size,
                             cfg.latent_size),
                  "context": (2, cfg.text_len, cfg.text_width)}
    shapes_end = {"latent": shapes_mid["latent"]}
    for res in results.values():
        mid = res.n_cloud < n_total
        want = wire_nbytes(shapes_mid if mid else shapes_end, "int8")
        if len(res.payload) != want:
            raise RuntimeError(f"{res.request_id}: payload of "
                               f"{len(res.payload)} B, expected {want} B")
    # one launch a group: the group's latent and context together
    expected = len(groups)
    if launches <= 0 or launches != expected or len(encoded) != expected:
        raise RuntimeError(f"int8 kernel launched {launches} times in "
                           f"{len(encoded)} encodings on the serving path, "
                           f"expected {expected}")
    kernel_entry["launches"] = launches
    equal = check_served_payloads(engine, encoded)
    emit("serve", config=cfg.name, parameters=n_params,
         init_seconds=init_s, serve_seconds=serve_s,
         groups=[{"n_cloud": n, "batch": len(m),
                  "gpu_seconds": results[m[0].request_id].cloud_seconds
                  * len(m),
                  "payload_bytes": [len(results[r.request_id].payload)
                                    for r in m]}
                 for n, m in sorted(groups.items())],
         stats=engine.stats, int8_launches=launches,
         int8_launches_expected=expected,
         int8_encode_seconds=[e["seconds"] for e in encoded],
         payloads_bit_equal=equal,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return params, cfg, cost, link, results, groups


def check_served_payloads(engine, encoded: list) -> dict:
    """Each served payload against the same group's boundary encoded
    through the quantiser's plain version on the card, and through
    ``pack_boundary_wire`` with the numpy quantiser on the host: equal
    byte for byte, or this raises."""
    from repro_torch.core.transport import (get_wire_format,
                                            pack_boundary_wire,
                                            rowwise_quantize_int8)
    from repro_torch.kernels import int8_quant
    fmt = get_wire_format(engine.wire)
    kernel = int8_quant.int8_quantize_group
    counts = {"plain": 0, "numpy": 0}
    for e in encoded:
        lat, ctx2, served = e["lat"], e["ctx2"], e["payloads"]
        int8_quant.int8_quantize_group = int8_quant.int8_quantize_group_ref
        try:
            plain = engine._encode_int8_group(lat, ctx2, fmt)
        finally:
            int8_quant.int8_quantize_group = kernel
        lat_np = lat.float().cpu().numpy()
        ctx_np = None if ctx2 is None else ctx2.float().cpu().numpy()
        host = [pack_boundary_wire(
            lat_np[i], None if ctx_np is None else ctx_np[:, i], fmt,
            rowwise=rowwise_quantize_int8) for i in range(len(served))]
        for name, want in (("plain", plain), ("numpy", host)):
            if want != served:
                raise RuntimeError(f"served int8 payloads differ from the "
                                   f"{name} version's")
            counts[name] += len(want)
    return counts


def phase_device(params, cfg, cost, link, results, groups) -> None:
    from repro_torch.core.transport import deserialize, unpack_boundary
    from repro_torch.serving.engine import (DiffusionDeviceSim,
                                            DiffusionSplitEngine)
    sim = DiffusionDeviceSim(params, cfg, device="cuda")
    size = cfg.image_size
    done = []
    for n_cloud, members in sorted(groups.items()):
        res = results[members[0].request_id]
        t0 = time.perf_counter()
        img = sim.complete(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if tuple(img.shape) != (1, 3, size, size):
            raise RuntimeError(f"image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError("image has non-finite values")
        if float(img.abs().max()) > 1.0:
            raise RuntimeError("image leaves [-1, 1]")
        done.append({"n_cloud": n_cloud, "request": res.request_id,
                     "seconds": seconds, "min": float(img.min()),
                     "max": float(img.max())})

    # One shipped payload against the fp32 latent it encodes: the same
    # group, same seed, through an engine that ships fp32.
    n_mid = min(n for n in groups if 0 < n < cfg.n_total_iterations)
    members = groups[n_mid]
    ref_engine = DiffusionSplitEngine(params, cfg, cost, link=link,
                                      wire="fp32", device="cuda")
    ref = ref_engine.process_group(members, n_mid, seed=SEED)
    lat_ref, _ = unpack_boundary(ref[0].payload)
    payload = results[members[0].request_id].payload
    lat_deq, ctx_deq = unpack_boundary(payload)
    scales = deserialize(payload)["latent_rowscales"]          # (C, 1)
    rows = lat_ref.shape[0]
    err = np.abs(lat_deq - lat_ref).reshape(rows, -1).max(axis=1)
    # half a quantisation step, plus room for the two runs' latents
    # differing in their last bits
    limit = scales[:, 0] / 2 + 1e-4 * np.abs(lat_ref).max()
    if ctx_deq is None or not np.all(err <= limit):
        raise RuntimeError(f"dequantised latent off by {err.tolist()}, "
                           f"limit {limit.tolist()}")

    # The paper's claim that splitting does not change the output: the
    # fp32-wire split of that group, finished on the device side, against
    # all iterations and the VAE on one machine from the same start.
    from repro_torch.models import diffusion
    split_img = sim.complete(ref[0])
    dev = torch.device("cuda")
    cond = torch.from_numpy(np.concatenate(
        [r.cond_tokens for r in members])).to(dev)
    uncond = torch.from_numpy(np.concatenate(
        [r.uncond_tokens for r in members])).to(dev)
    lat0 = torch.randn(
        (len(members), cfg.latent_channels, cfg.latent_size,
         cfg.latent_size),
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    ctx2 = diffusion.encode_prompt(params, cfg, cond, uncond)
    mono_img = diffusion.apply_vae_decoder(
        params["vae"], cfg, diffusion.denoise_range(
            params, cfg, lat0, ctx2, 0, cfg.n_total_iterations))
    split_err = float((split_img - mono_img[:1]).abs().max())
    if not split_err <= SPLIT_ATOL:
        raise RuntimeError(f"split and one-machine images differ by "
                           f"{split_err} > {SPLIT_ATOL}")
    emit("device", completed=done, stats=sim.stats,
         payload_check={"n_cloud": n_mid, "row_max_err": err.tolist(),
                        "row_limit": limit.tolist()},
         split_vs_one_machine={"n_cloud": n_mid, "max_abs_err": split_err,
                               "atol": SPLIT_ATOL})


def _within(got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: dict) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def flash_bound(B, Hq, Hkv, Sq, Skv, d, causal, window, itemsize):
    """Least time for one call: the larger of q, k, v read and o written
    once over the memory rate, and 4 d operations (two products) for
    each unmasked (query, key) pair over the bf16 tensor-core rate."""
    q_pos = np.arange(Sq)
    hi = np.minimum(q_pos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(Sq)
    pairs = float(np.clip(hi - lo, 0, None).sum())
    flops = 4.0 * B * Hq * d * pairs
    nbytes = (2 * B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def rglru_bound(B, S, W):
    """a and b read, h written, fp32; two operations an element."""
    nbytes = 3 * B * S * W * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * B * S * W / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def lm_path_shapes():
    """The shapes the layer-split path gives the two kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    flash = (LM_BATCH, LM_SEQ, LM_SEQ, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim(), True, cfg.window)
    return cfg, flash, (LM_BATCH, LM_SEQ, cfg.rglru.lru_width)


def prefill_flash_shape():
    """The shape decode_serve's prefill gives the flash kernel: Qwen2-7B,
    8 sequences of 4096 tokens, causal, no window."""
    from repro_torch.configs import get_config
    cfg = get_config(DECODE_ARCH)
    return (DECODE_BATCH, DECODE_PROMPT, DECODE_PROMPT, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim(), True, cfg.window)


def flash_prefill_entry(fa, gen, checks: list) -> dict:
    """The flash kernel at Qwen2-7B's prefill shape: held to its plain
    version at batch 1, batch 8 held to batch 1 bit for bit on the
    sequence they share, then timed at batch 8 beside the plain version
    (whose fp32 scores take 15 GB there) and SDPA."""
    import torch.nn.functional as F
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape = prefill_flash_shape()

    def n(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = n(B * Hq, Sq, D), n(B * Hkv, Skv, D), n(B * Hkv, Skv, D)
    q1, k1, v1 = q[:Hq], k[:Hkv], v[:Hkv]
    o1 = fa.flash_attention(q1, k1, v1, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q1, k1, v1, causal=causal, window=window)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    err = float((o1.float() - want.float()).abs().max())
    checks.append({"shape": [1] + list(shape[1:]), "kv_len": None,
                   "dtype": str(torch.bfloat16), "max_abs_err": err,
                   "atol": atol, "rtol": rtol,
                   "out_std": float(want.float().std())})
    if not _within(o1, want, atol, rtol):
        raise RuntimeError(f"flash_attention{shape} at batch 1 disagrees "
                           f"with its plain version: max|d|={err}")

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D),
            v.view(B, Hkv, Skv, D), is_causal=True, enable_gqa=True)
    o = run_kernel()
    torch.cuda.synchronize()
    if not torch.equal(o[:Hq], o1) or not bool(torch.isfinite(o).all()):
        raise RuntimeError(f"flash_attention{shape}: batch 8 differs from "
                           "batch 1 on their shared sequence")
    lib_err = float((run_library()[:1].reshape(q1.shape).float()
                     - want.float()).abs().max())
    del o, o1, want
    plain_a = time_ms(run_plain, inner=1, samples=3)
    kern_a = time_ms(run_kernel, inner=2, samples=5)
    kern_b = time_ms(run_kernel, inner=2, samples=5)
    plain_b = time_ms(run_plain, inner=1, samples=3)
    library = time_ms(run_library, inner=2, samples=5)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, q.element_size())
    return {
        "shape": list(shape), "dtype": str(torch.bfloat16),
        "launches": None,                 # filled in by decode_serve
        "max_abs_err": err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
        "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        "library_max_abs_err_vs_plain": lib_err,
        "timed": "one Qwen2-7B prefill attention layer at batch 8, bf16; "
                 "kernel and SDPA median of 5 x 2 calls, plain version of "
                 "3 x 1; best of 2",
        "bytes": nbytes, "flops": flops,
    }


def phase_lm_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as lru
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _, flash_path, lru_path = lm_path_shapes()
    # the path's head_dim, window and length in fp32, one request (the
    # d = 256 instantiation is held to the fp32 tolerance here)
    flash_path32 = (1,) + flash_path[1:]

    def qkv(B, Sq, Skv, Hq, Hkv, D, dtype):
        def n(*shape):
            return torch.randn(shape, generator=gen,
                               device="cuda").to(dtype)
        return n(B * Hq, Sq, D), n(B * Hkv, Skv, D), n(B * Hkv, Skv, D)

    flash_checks = []
    path_inputs = path32_inputs = None
    cases = [(c, None, dt) for c in FLASH_GRID for dt in FLASH_TOL]
    cases += [(c, kv_len, dt) for c, kv_len in FLASH_RAGGED
              for dt in FLASH_TOL]
    cases.append((flash_path32, None, torch.float32))
    cases.append((flash_path, None, torch.bfloat16))
    # the prefill path's head_dim 128 and group 7 in fp32, one sequence
    cases.append(((1,) + prefill_flash_shape()[1:], None, torch.float32))
    for case, kv_len, dtype in cases:
        B, Sq, Skv, Hq, Hkv, D, causal, window = case
        q, k, v = qkv(B, Sq, Skv, Hq, Hkv, D, dtype)
        o = fa.flash_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
        atol, rtol = FLASH_TOL[dtype]
        diff = o.float() - want.float()
        err = float(diff.abs().max())
        flash_checks.append({
            "shape": list(case), "kv_len": kv_len, "dtype": str(dtype),
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "rel_l2": float(diff.norm() / want.float().norm()),
            "out_std": float(want.float().std())})
        if o.dtype != dtype or not _within(o, want, atol, rtol):
            raise RuntimeError(f"flash_attention{case} {dtype} disagrees "
                               f"with its plain version: max|d|={err}")
        del o, want, diff
        if case == flash_path:
            path_inputs, path_err = (q, k, v), err
        elif case == flash_path32:
            path32_inputs = (q, k, v)

    lru_checks = []
    for (B, S, W), with_h0 in [(c, True) for c in RGLRU_GRID] + [
            (lru_path, False)]:
        a = 0.8 + 0.199 * torch.rand((B, S, W), generator=gen, device="cuda")
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        h0 = (torch.randn((B, W), generator=gen, device="cuda")
              if with_h0 else None)
        h = lru.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err = float((h - lru.rglru_scan_ref(a, b, h0)).abs().max())
        lru_checks.append({"shape": [B, S, W], "h0": with_h0,
                           "max_abs_err": err, "atol": RGLRU_ATOL})
        if not err <= RGLRU_ATOL:
            raise RuntimeError(f"rglru_scan{(B, S, W)} disagrees with its "
                               f"plain version: max|d|={err}")
    lru_inputs = (a, b)

    # times at the path's shapes; kernel and plain version in turns
    B, Sq, Skv, Hq, Hkv, D, causal, window = flash_path
    q, k, v = path_inputs
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda").tril()
    mask &= ~torch.ones_like(mask).tril(-window)

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D),
            v.view(B, Hkv, Skv, D), attn_mask=mask, enable_gqa=True)
    lib_err = float((run_library().reshape(q.shape).float()
                     - run_plain().float()).abs().max())
    plain_a = time_ms(run_plain, inner=2, samples=5)
    kern_a = time_ms(run_kernel, inner=2, samples=5)
    kern_b = time_ms(run_kernel, inner=2, samples=5)
    plain_b = time_ms(run_plain, inner=2, samples=5)
    library = time_ms(run_library, inner=2, samples=5)
    q32, k32, v32 = path32_inputs
    fp32_ms = time_ms(lambda: fa.flash_attention(
        q32, k32, v32, causal=causal, window=window), inner=2, samples=5)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, q.element_size())
    prefill = flash_prefill_entry(fa, gen, flash_checks)
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": None,                     # filled in by lm_serve
        "max_abs_err": path_err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True, "
                        "boolean causal-window mask)",
        "library_max_abs_err_vs_plain": lib_err,
        "timed": f"one RecurrentGemma-9B attention layer {list(flash_path)} "
                 "bf16; median of 5 x 2 calls, best of 2",
        "bytes": nbytes, "flops": flops,
        "fp32_ms": fp32_ms,
        "fp32_timed": f"the fp32 kernel at {list(flash_path32)}; median of "
                      "5 x 2 calls",
        "qwen2_7b_prefill": prefill,
    }

    a, b = lru_inputs
    plain_a = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    kern_a = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    kern_b = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    plain_b = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    bound_ms, bound_by, nbytes = rglru_bound(*lru_path)
    lru_entry = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:43",
        "launches": None,                     # filled in by lm_serve
        "max_abs_err": lru_checks[-1]["max_abs_err"],
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # no single PyTorch call computes a linear recurrence
        "library_ms": None,
        "timed": f"one RecurrentGemma-9B recurrent layer {list(lru_path)} "
                 "fp32, h0 None as the model passes it; median of 5 x 2 "
                 "calls, best of 2",
        "bytes": nbytes,
    }
    emit("lm_kernels", flash_checks=flash_checks, rglru_checks=lru_checks,
         flash_attention=flash_entry, rglru_scan=lru_entry)
    return {"flash_attention": flash_entry, "rglru_scan": lru_entry}


def _layers_run(cfg, start: int, stop: int) -> dict:
    """Kernel launches one run of ``run_layer_range(start, stop)`` makes:
    one a layer of each kind, and the tail whenever ``stop == G``."""
    kinds = list(cfg.block_pattern) * (stop - start)
    if stop == cfg.num_groups():
        kinds += list(cfg.tail_pattern())
    return {"flash_attention": kinds.count("attn"), "decode_attention": 0,
            "rglru_scan": kinds.count("rec"),
            "ssd_scan": kinds.count("ssd")}


def _decode_step_launches(cfg, steps: int) -> dict:
    """Kernel launches ``steps`` decode steps make: one a layer, decode
    attention for each attention layer."""
    run = _layers_run(cfg, 0, cfg.num_groups())
    return {"flash_attention": 0,
            "decode_attention": steps * run["flash_attention"],
            "rglru_scan": steps * run["rglru_scan"],
            "ssd_scan": steps * run["ssd_scan"]}


def _launch_modules() -> dict:
    from repro_torch.serving.profile_split import WRAPPERS
    return WRAPPERS


def launch_counts() -> dict:
    """The hand kernels' wrapper counts, by kernel."""
    return {n: m.launch_count for n, m in _launch_modules().items()}


def reset_launch_counts() -> None:
    for m in _launch_modules().values():
        m.launch_count = 0


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launch_counts().items()}


def _ssd_plain(x, dt, A, Bm, Cm, *, chunk_size, init_state=None):
    from repro_torch.kernels import ssd_scan as ssd
    return ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk_size, init_state)


class plain_versions:
    """Within the block, the named wrappers ("flash_attention",
    "decode_attention", "rglru_scan", "ssd_scan") run their plain versions
    on CUDA tensors, so the model's forward can be held against itself
    without those kernels on this card."""

    def __init__(self, *names):
        modules = _launch_modules()
        plain = {"flash_attention": modules["flash_attention"]
                 .flash_attention_ref,
                 "decode_attention": modules["decode_attention"]
                 .decode_attention_ref,
                 "rglru_scan": modules["rglru_scan"].rglru_scan_ref,
                 "ssd_scan": _ssd_plain}
        self._swaps = [(modules[n], n, plain[n]) for n in names]

    def __enter__(self):
        self._saved = [getattr(m, n) for m, n, _ in self._swaps]
        for m, n, plain in self._swaps:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for (m, n, _), kernel in zip(self._swaps, self._saved):
            setattr(m, n, kernel)
        return False


def init_full_width(arch: str, want_params: int, want_bytes: int):
    """Full-width parameters of ``arch`` drawn on the card from SEED;
    raises unless the tree holds the reference's count and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = tr.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = _nbytes(params)
    if (n_params, n_bytes) != (want_params, want_bytes):
        raise RuntimeError(f"{arch}: {n_params} parameters in {n_bytes} B, "
                           f"the reference's tree holds {want_params} in "
                           f"{want_bytes} B")
    return cfg, params, {"config": cfg.name, "parameters": n_params,
                         "parameter_bytes": n_bytes, "init_seconds": init_s}


def serve_plan(cfg, params, plan):
    """Each (g, tokens) of ``plan`` through a new pair of layer-split
    engines on the card: payload bytes checked, the launch counts set to
    0 just before the first split and read just after the last.  A side
    runs its layers twice where its key missed the cache (the warm-up,
    then the timed run).  Returns the engines, each split's logits and the
    record of the serve."""
    from repro_torch.core.segmentation import hidden_payload_bytes
    from repro_torch.core.transport import WAN_LINK
    from repro_torch.serving.engine import LayerSplitDevice, LayerSplitEngine
    G = cfg.num_groups()
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cuda")
    device = LayerSplitDevice(params, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    expected = dict.fromkeys(launch_counts(), 0)
    forwards = 0                     # whole forwards, warm-ups included
    splits, logits = [], {}
    t_serve = time.perf_counter()
    for g, toks in plan:
        cloud_before, device_before = dict(cloud.stats), dict(device.stats)
        payload, t_net = cloud.process({"tokens": toks}, g)
        out = device.complete(payload, g)
        torch.cuda.synchronize()
        logits[g] = out
        split = {"group": g, "batch": toks.shape[0],
                 "payload_bytes": payload.nbytes, "t_net_seconds": t_net}
        sides_runs = []
        for name, side, (start, stop), before in (
                ("cloud", cloud, (0, g), cloud_before),
                ("device", device, (g, G), device_before)):
            runs = 2 if side.stats["cache_misses"] > before[
                "cache_misses"] else 1           # a miss warms up first
            sides_runs.append(runs)
            per_run = _layers_run(cfg, start, stop)
            for kname, n in per_run.items():
                expected[kname] += runs * n
            split[name] = {
                "gpu_seconds": side.stats["gpu_seconds"]
                - before["gpu_seconds"],
                "compile_seconds": side.stats["compile_seconds"]
                - before["compile_seconds"],
                "runs": runs, "launches_per_run": per_run}
        if sides_runs[0] != sides_runs[1]:
            raise RuntimeError(f"g={g}: the sides ran {sides_runs} times")
        forwards += sides_runs[0]
        want_bytes = hidden_payload_bytes(cfg, toks.shape[0],
                                          toks.shape[1], 2)
        if payload.nbytes != want_bytes or payload.dtype != np.float16:
            raise RuntimeError(f"g={g}: payload of {payload.nbytes} B "
                               f"{payload.dtype}, expected {want_bytes} B "
                               "fp16")
        splits.append(split)
    record = {"serve_seconds": time.perf_counter() - t_serve,
              "splits": splits, "launches": launch_counts(),
              "launches_expected": expected, "whole_forwards": forwards,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if record["launches"] != expected:
        raise RuntimeError(f"layer-split path launched {record['launches']},"
                           f" expected {expected}")
    return cloud, device, logits, record


def profile_split(cloud, device, tokens, group: int) -> dict:
    """One more round at ``group`` through the warm engines under
    ``torch.profiler``; raises if nothing ran on the card or the wrappers
    launched other than one run of each side's layers."""
    from repro_torch.serving.profile_split import profile_round
    cfg = cloud.cfg
    out = profile_round(cloud, device, tokens, group)
    if out["device_seconds"] is None:
        raise RuntimeError("the profiler recorded no device activity")
    device_run = _layers_run(cfg, group, cfg.num_groups())
    per_run = {k: n + device_run[k]
               for k, n in _layers_run(cfg, 0, group).items()}
    if out["wrapper_launches"] != per_run:
        raise RuntimeError(f"profiled round launched "
                           f"{out['wrapper_launches']}, expected {per_run}")
    return out


def phase_lm_serve(entries: dict):
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(LM_ARCH, LM_PARAMETERS,
                                        LM_PARAMETER_BYTES)
    G = cfg.num_groups()
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)
    # the paper's split at the middle group for the whole batch, and the
    # two ends of the range (all on the device, all in the cloud) for one
    # request, the split points tests/test_serving.py uses
    plan = ((G // 2, tokens), (0, tokens[:1]), (G, tokens[:1]))
    cloud, device, logits, record = serve_plan(cfg, params, plan)
    splits, launches = record["splits"], record["launches"]
    if 0 in (launches[n] for n in entries):
        raise RuntimeError(f"layer-split path launched {launches}")
    for name in entries:
        entries[name]["launches"] = launches[name]

    # one machine, same tokens, same kernels: forward_hidden + head
    kernels = ops.kernel_registry()
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    hidden, _, _ = tr.forward_hidden(params, batch, cfg, kernels=kernels)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    # at g == G the reference's engines run the tail layers on both sides
    # (run_layer_range runs the tail whenever stop_group == G); the port
    # keeps that, so that split is held to the same forward with the tail
    # run twice
    pos = torch.arange(LM_SEQ, device="cuda")
    x = tr.run_layer_range(params, tr.embed_inputs(
        params, {"tokens": batch["tokens"][:1]}, cfg), cfg, None,
        start_group=0, stop_group=G, positions=pos, kernels=kernels)
    x = tr.run_layer_range(params, x, cfg, None, start_group=G,
                           stop_group=G, positions=pos, kernels=kernels)
    want_tail_twice = tr.unembed(
        params, tr.apply_norm(params["final_norm"], x)[:, -1:], cfg)
    targets = {G // 2: (want, "forward_hidden + unembed"),
               0: (want[:1], "forward_hidden + unembed"),
               G: (want_tail_twice, "one machine, tail twice as in the "
                   "split")}
    for split in splits:
        g = split["group"]
        target, what = targets[g]
        err = float((logits[g].float() - target.float()).abs().max())
        split.update(logit_max_abs_err=err, compared_with=what)
        if not _within(logits[g], target, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
            raise RuntimeError(f"g={g}: split logits differ from {what} "
                               f"by {err}")
        if not bool(torch.isfinite(logits[g]).all()):
            raise RuntimeError(f"g={g}: non-finite logits")

    # the same forward through the plain versions, on this card: both at
    # once (the check), then each alone (how far one kernel's rounding
    # carries through the 38 layers)
    V = cfg.vocab_size

    def rel_l2(got, ref):
        diff = got[..., :V].float() - ref[..., :V].float()
        return float(diff.norm() / ref[..., :V].float().norm())

    vs_plain, plain_both = {}, None
    both = ("flash_attention", "rglru_scan")
    for names in (both, ("flash_attention",), ("rglru_scan",)):
        counts = launch_counts()
        with plain_versions(*names):
            hidden_p, _, _ = tr.forward_hidden(params, batch, cfg,
                                               kernels=kernels)
            plain = tr.unembed(params, hidden_p[:, -1:], cfg).float()
        torch.cuda.synchronize()
        launched = launches_since(counts)
        if launched != {k: 0 if k in names else n
                        for k, n in _layers_run(cfg, 0, G).items()}:
            raise RuntimeError(f"plain_versions{names}: launched {launched}")
        vs_plain["plain " + " + ".join(names)] = {
            "logits_rel_l2": rel_l2(want, plain),
            "logits_max_abs_err": float((want.float() - plain).abs().max())}
        if names == both:
            plain_both = plain
    del hidden_p
    kernels_vs_plain = vs_plain["plain flash_attention + rglru_scan"][
        "logits_rel_l2"]
    if not kernels_vs_plain <= LM_PLAIN_REL_L2:
        raise RuntimeError(f"kernels vs plain versions: relative L2 error "
                           f"of the logits {kernels_vs_plain} > "
                           f"{LM_PLAIN_REL_L2}")

    # every parameter cast to fp32, request 0: the forward through the
    # kernels against the one through the plain versions (the check that
    # can see a kernel's fault), and the latter as exact arithmetic for
    # the bf16 forwards
    params32 = _tree_map(lambda t: t.float(), params)
    batch0 = {"tokens": batch["tokens"][:1]}

    def forward32():
        hidden32, _, _ = tr.forward_hidden(params32, batch0, cfg,
                                           kernels=kernels)
        return tr.unembed(params32, hidden32[:, -1:], cfg)
    counts = launch_counts()
    kernels32 = forward32()
    torch.cuda.synchronize()
    launched = launches_since(counts)
    if launched != _layers_run(cfg, 0, G):
        raise RuntimeError(f"fp32 forward launched {launched}")
    with plain_versions(*both):
        exact = forward32()
    torch.cuda.synchronize()
    del params32
    torch.cuda.empty_cache()
    fp32_vs_plain = {
        "logits_rel_l2": rel_l2(kernels32, exact),
        "logits_max_abs_err": float((kernels32[..., :V].float()
                                     - exact[..., :V].float()).abs().max()),
        "logits_rms": float(exact[..., :V].float().square().mean().sqrt())}
    if not fp32_vs_plain["logits_rel_l2"] <= LM_FP32_PLAIN_REL_L2:
        raise RuntimeError(f"fp32 forward, kernels vs plain versions: "
                           f"relative L2 error of the logits "
                           f"{fp32_vs_plain['logits_rel_l2']} > "
                           f"{LM_FP32_PLAIN_REL_L2}")
    vs_fp32 = {"kernels": rel_l2(want[:1], exact),
               "plain versions": rel_l2(plain_both[:1], exact)}
    if not vs_fp32["kernels"] <= LM_FP32_RATIO * vs_fp32["plain versions"]:
        raise RuntimeError(f"bf16 forward against fp32: relative L2 error "
                           f"{vs_fp32['kernels']} through the kernels, "
                           f"{vs_fp32['plain versions']} through the plain "
                           f"versions (limit {LM_FP32_RATIO}x)")
    emit("lm_serve", **info, batch=LM_BATCH, seq=LM_SEQ, groups=G,
         tail=list(cfg.tail_pattern()), **record, engine_stats=cloud.stats,
         device_stats=device.stats, fp32_kernels_vs_plain=fp32_vs_plain,
         limit_fp32_rel_l2=LM_FP32_PLAIN_REL_L2,
         kernels_vs_plain=vs_plain, limit_rel_l2=LM_PLAIN_REL_L2,
         bf16_vs_fp32_rel_l2=vs_fp32, limit_fp32_ratio=LM_FP32_RATIO)
    return cloud, device, tokens


def phase_lm_profile(cloud, device, tokens) -> None:
    """One more round of the served batch at g = G // 2, through the
    warm engines of ``lm_serve``, under ``torch.profiler``."""
    emit("lm_profile", **profile_split(cloud, device, tokens,
                                       cloud.cfg.num_groups() // 2))


def ssd_path_shape():
    """(b, S, H, P, G, N, Q) the layer-split path gives the SSD kernel."""
    from repro_torch.configs import get_config
    cfg = get_config(SSD_ARCH)
    s = cfg.ssm
    return (LM_BATCH, LM_SEQ, s.n_heads(cfg.d_model), s.head_dim,
            s.n_groups, s.d_state, s.chunk_size)


def ssd_bound(b, S, H, P, G, N, Q, with_init=False):
    """Least time for one call.  Operations: each chunk's Q(Q+1)/2
    causal (query, key) pairs take N multiply-adds for the score and P
    for its product with x, and the state's read and update 2 Q N P more,
    over the fp32 rate (the masked upper triangle is work no kernel needs;
    ``flops_full_square`` counts the Q x Q square the TPU kernel
    computes).  Bytes: x, dt, A, B, C (and init_state) read once, y and
    the final state written once, fp32."""
    chunks = b * H * (S // Q)
    pairs = Q * (Q + 1) // 2
    flops = chunks * (2 * pairs * (N + P) + 4 * Q * N * P)
    square = chunks * (2 * Q * Q * (N + P) + 4 * Q * N * P)
    nbytes = 4 * (2 * b * S * H * P + b * S * H + H + 2 * b * S * G * N
                  + b * H * P * N * (2 if with_init else 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            square)


def ssd_three_phases(x, dt, A, Bm, Cm, Q, init_state=None):
    """The SSD C entry handed scratch, so that it runs the three phases at
    any length, S = 1 included (where the wrapper hands none and gets the
    step kernel).  Not a launch of the main path: it counts nowhere."""
    from repro_torch.kernels import _build
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // Q
    y, final = torch.empty_like(x), x.new_empty((b, H, P, N))
    states, decay = x.new_empty((b, H, nc, P, N)), x.new_empty((b, H, nc))
    lib = _build.load_library()
    _build.check_launch(lib, lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), states.data_ptr(), decay.data_ptr(),
        b, S, H, P, G, N, Q, torch.cuda.current_stream().cuda_stream),
        "ssd_scan")
    return y, final


def phase_ssd_kernels() -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    path = ssd_path_shape()
    batch1 = (1,) + path[1:]
    checks, timed_inputs = [], {}
    cases = ([(c, True) for c in SSD_GRID] + [(c, w) for c in SSD_ONE_CHUNK
                                              for w in (True, False)]
             + [(batch1, False), (path, False)])
    for case, with_init in cases:
        b, S, H, P, G, N, Q = case
        x, dt = normal(b, S, H, P), uniform(0.001, 0.1, b, S, H)
        A = -uniform(0.5, 2.0, H)
        Bm, Cm = normal(b, S, G, N), normal(b, S, G, N)
        st = normal(b, H, P, N) if with_init else None
        y, final = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=Q,
                                init_state=st)
        torch.cuda.synchronize()
        y_ref, final_ref = ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, Q, st)
        y_err = float((y - y_ref).abs().max())
        final_err = float((final - final_ref).abs().max())
        checks.append({"shape": list(case), "init_state": with_init,
                       "chunks": S // min(Q, S),
                       "y_max_abs_err": y_err, "y_atol": SSD_Y_ATOL,
                       "final_max_abs_err": final_err,
                       "final_atol": SSD_FINAL_ATOL,
                       "y_max_abs": float(y_ref.abs().max())})
        if (y.shape != y_ref.shape or final.shape != final_ref.shape
                or not bool(torch.isfinite(y).all())
                or not bool(torch.isfinite(final).all())):
            raise RuntimeError(f"ssd_scan{case}: wrong shapes or non-finite "
                               "values")
        if not (y_err <= SSD_Y_ATOL and final_err <= SSD_FINAL_ATOL):
            raise RuntimeError(f"ssd_scan{case} disagrees with its plain "
                               f"version: max|dy|={y_err}, "
                               f"max|dfinal|={final_err}")
        if S == 1:
            y3, final3 = ssd_three_phases(x, dt, A, Bm, Cm, 1, st)
            torch.cuda.synchronize()
            checks[-1]["step_kernel_equals_three_phases"] = bool(
                torch.equal(y, y3) and torch.equal(final, final3))
            if not checks[-1]["step_kernel_equals_three_phases"]:
                raise RuntimeError(f"ssd_scan{case}: the step kernel and "
                                   "the three phases differ")
        if case in (batch1, path):
            timed_inputs[case] = ((x, dt, A, Bm, Cm),
                                  max(y_err, final_err))
        del y, final, y_ref, final_ref

    def times(case):
        """Kernel and plain version in turns (no init_state, as the model
        passes it)."""
        args, err = timed_inputs[case]
        Q = case[-1]
        plain_a = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                          samples=5)
        kern_a = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q),
                         inner=2, samples=5)
        kern_b = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q),
                         inner=2, samples=5)
        plain_b = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                          samples=5)
        bound_ms, bound_by, nbytes, flops, square = ssd_bound(*case)
        return {"max_abs_err": err, "ms": min(kern_a, kern_b),
                "plain_ms": min(plain_a, plain_b), "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "flops_full_square": square,
                "bound_ms_full_square": square / FP32_FLOP_PER_S * 1e3}
    at_path = times(path)
    at_batch1 = times(batch1)
    at_batch1.update(timed=f"one Mamba-2-780M SSD layer {list(batch1)} "
                           "fp32 (request 0 alone, as the g = 0 and g = 48 "
                           "splits run it); median of 5 x 2 calls, best "
                           "of 2")
    entry = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": None,                     # filled in by mamba_serve
        **{key: at_path[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        # no single PyTorch call computes a chunked state-space scan
        "library_ms": None,
        "timed": f"one Mamba-2-780M SSD layer {list(path)} fp32, "
                 "init_state None as the model passes it; median of 5 x 2 "
                 "calls, best of 2",
        **{key: at_path[key] for key in (
            "bytes", "flops", "flops_full_square", "bound_ms_full_square")},
        "batch_1": at_batch1,
    }
    emit("ssd_kernels", checks=checks, ssd_scan=entry,
         before_ms=SSD_BEFORE_MS,
         memory_allocated_bytes=torch.cuda.memory_allocated())
    return entry


def _rel_l2(got, ref, vocab):
    diff = got[..., :vocab].float() - ref[..., :vocab].float()
    return float(diff.norm() / ref[..., :vocab].float().norm())


def phase_mamba_serve(entry: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(SSD_ARCH, SSD_PARAMETERS,
                                        SSD_PARAMETER_BYTES)
    G = cfg.num_groups()
    if cfg.tail_pattern() or cfg.block_pattern != ("ssd",):
        raise RuntimeError(f"{SSD_ARCH}: expected {G} ssd layers, no tail")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)
    plan = ((SSD_SPLIT, tokens), (0, tokens[:1]), (G, tokens[:1]))
    cloud, device, logits, record = serve_plan(cfg, params, plan)
    splits, launches = record["splits"], record["launches"]
    if launches["ssd_scan"] != G * record["whole_forwards"] or not launches[
            "ssd_scan"]:
        raise RuntimeError(f"layer-split path launched {launches}, not {G} "
                           f"SSD launches in each of "
                           f"{record['whole_forwards']} whole forwards")
    entry["launches"] = launches["ssd_scan"]

    # one machine, same tokens, same kernel: forward_hidden + head (no
    # tail, so the g == G split runs nothing twice)
    kernels = ops.kernel_registry()
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    counts = launch_counts()
    hidden, _, _ = tr.forward_hidden(params, batch, cfg, kernels=kernels)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    del hidden
    torch.cuda.synchronize()
    if launches_since(counts) != _layers_run(cfg, 0, G):
        raise RuntimeError(f"one-machine forward launched "
                           f"{launches_since(counts)}")
    for split in splits:
        g = split["group"]
        target = want if g == SSD_SPLIT else want[:1]
        err = float((logits[g].float() - target.float()).abs().max())
        split.update(logit_max_abs_err=err,
                     compared_with="forward_hidden + unembed")
        if not bool(torch.isfinite(logits[g]).all()):
            raise RuntimeError(f"g={g}: non-finite logits")
        if not _within(logits[g], target, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
            raise RuntimeError(f"g={g}: split logits differ from the "
                               f"one-machine forward by {err}")

    # every parameter cast to fp32, request 0: the forward through the
    # kernel against the one through its plain version
    params32 = _tree_map(lambda t: t.float(), params)
    batch0 = {"tokens": batch["tokens"][:1]}

    def forward32():
        hidden32, _, _ = tr.forward_hidden(params32, batch0, cfg,
                                           kernels=kernels)
        return tr.unembed(params32, hidden32[:, -1:], cfg)
    counts = launch_counts()
    kernels32 = forward32()
    torch.cuda.synchronize()
    if launches_since(counts) != _layers_run(cfg, 0, G):
        raise RuntimeError(f"fp32 forward launched {launches_since(counts)}")
    counts = launch_counts()
    with plain_versions("ssd_scan"):
        exact = forward32()
    torch.cuda.synchronize()
    if launches_since(counts)["ssd_scan"] != 0:
        raise RuntimeError("the plain fp32 forward launched the kernel")
    del params32
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    fp32_vs_plain = {
        "logits_rel_l2": _rel_l2(kernels32, exact, V),
        "logits_max_abs_err": float((kernels32[..., :V].float()
                                     - exact[..., :V].float()).abs().max()),
        "logits_rms": float(exact[..., :V].float().square().mean().sqrt())}
    if not fp32_vs_plain["logits_rel_l2"] <= SSD_FP32_PLAIN_REL_L2:
        raise RuntimeError(f"fp32 forward, kernel vs plain version: "
                           f"relative L2 error of the logits "
                           f"{fp32_vs_plain['logits_rel_l2']} > "
                           f"{SSD_FP32_PLAIN_REL_L2}")
    bf16_vs_fp32 = _rel_l2(want[:1], exact, V)

    # one more round at g = SSD_SPLIT through the warm engines, traced
    prof = profile_split(cloud, device, tokens, SSD_SPLIT)
    prof["ssd_share"] = (prof["by_class"].get("ssd_scan", 0.0)
                         / prof["device_seconds"])
    emit("mamba_serve", **info, batch=LM_BATCH, seq=LM_SEQ, groups=G,
         **record, engine_stats=cloud.stats, device_stats=device.stats,
         fp32_kernel_vs_plain=fp32_vs_plain,
         limit_fp32_rel_l2=SSD_FP32_PLAIN_REL_L2,
         bf16_vs_fp32_rel_l2=bf16_vs_fp32, profile=prof)
    return cfg, params, tokens


def decode_bound(lengths, Hq, Hkv, d, itemsize):
    """Least time for one call: the larger of the valid keys and values
    read once (with q, lengths and o) over the memory rate, and 4 d
    operations (two products) for each (query head, valid key) over the
    bf16 tensor-core rate."""
    keys = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * keys * Hkv * d + 2 * B * Hq * d) * itemsize + 4 * B
    flops = 4.0 * keys * Hq * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def rg_decode_inputs(gen):
    """RecurrentGemma-9B's decode attention as ``lm_decode`` gives it at
    its first step: q (1, 16, 256) against the 2048-key window, a view
    inside a (1, 4112, 1, 256) bf16 cache."""
    lo, hi = RG_DECODE_VIEW
    q = torch.randn((1, 16, 256), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, RG_DECODE_CACHE, 1, 256), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    lens = torch.full((1,), hi - lo, dtype=torch.int32, device="cuda")
    return q, k[:, lo:hi], v[:, lo:hi], lens


def time_decode(q, k, v, lens) -> dict:
    """The wrapper, its plain version (in turns), SDPA, and the C entry
    alone (output and scratch allocated beforehand) on one input, with
    its bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    import torch.nn.functional as F
    B, Skv, Hkv, D = k.shape
    Hq = q.shape[1]
    mask = (torch.arange(Skv, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
    lib_err = float((run_library().float() - dec.decode_attention_ref(
        q, k, v, lens).float()).abs().max())

    def timed(fn):
        return time_ms(fn, inner=DECODE_TIMING_CALLS, samples=10)
    plain_a = timed(lambda: dec.decode_attention_ref(q, k, v, lens))
    kern_a = timed(lambda: dec.decode_attention(q, k, v, lens))
    kern_b = timed(lambda: dec.decode_attention(q, k, v, lens))
    plain_b = timed(lambda: dec.decode_attention_ref(q, k, v, lens))
    library = timed(run_library)

    lib = _build.load_library()
    chunk, n_splits = dec.split_plan(B * Hkv, Skv)
    o = torch.empty_like(q)
    part_acc = torch.empty((B * Hkv, n_splits, Hq // Hkv, D),
                           device="cuda")
    part_ml = torch.empty((B * Hkv, n_splits, Hq // Hkv, 2), device="cuda")
    raw_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, Hq,
                Hkv, Skv, D, *k.stride()[:3], *v.stride()[:3], chunk,
                n_splits, D ** -0.5, 1, torch.cuda.current_stream()
                .cuda_stream)
    _build.check_launch(lib, lib.repro_decode_attention(*raw_args),
                        "decode_attention")
    torch.cuda.synchronize()
    if not torch.equal(o, dec.decode_attention(q, k, v, lens)):
        raise RuntimeError("the raw launch and the wrapper differ")
    raw_ms = [timed(lambda: lib.repro_decode_attention(*raw_args))
              for _ in range(2)]
    bound_ms, bound_by, nbytes, flops = decode_bound(
        lens.tolist(), Hq, Hkv, D, q.element_size())
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library, "raw_launch_ms": min(raw_ms),
            "raw_launch_ms_turns": raw_ms,
            "library_max_abs_err_vs_plain": lib_err, "bytes": nbytes,
            "flops": flops, "split": [chunk, n_splits]}


def phase_decode_kernels() -> dict:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    checks = []

    def check(what, o, want, dtype, exact=None):
        atol, rtol = DECODE_TOL[dtype]
        err = float((o.float() - want.float()).abs().max())
        checks.append({"case": what, "dtype": str(dtype), "max_abs_err": err,
                       "atol": atol, "rtol": rtol})
        if (o.dtype != dtype or o.shape != want.shape
                or not bool(torch.isfinite(o).all())
                or not _within(o, want, atol, rtol)):
            raise RuntimeError(f"decode_attention {what} {dtype} disagrees "
                               f"with its plain version: max|d|={err}")
        if exact is not None and not torch.equal(o, exact):
            raise RuntimeError(f"decode_attention {what} {dtype}: a view "
                               "and its contiguous copy differ")
        return err

    path_err, path_inputs = None, None
    for case in DECODE_GRID + (DECODE_PATH,):
        B, Skv, Hq, Hkv, D = case
        for dtype in DECODE_TOL:
            q = normal(B, Hq, D).to(dtype)
            k, v = normal(B, Skv, Hkv, D).to(dtype), normal(
                B, Skv, Hkv, D).to(dtype)
            ragged = torch.randint(1, Skv + 1, (B,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            variants = [("ragged", ragged)]
            if case == DECODE_PATH:
                variants = [("path", torch.full_like(ragged,
                                                     DECODE_PATH_LENGTH))]
            variants += [("length 1", torch.ones_like(ragged)),
                         ("length Skv", torch.full_like(ragged, Skv))]
            for name, lens in variants:
                o = dec.decode_attention(q, k, v, lens)
                torch.cuda.synchronize()
                err = check(f"{list(case)} {name}", o,
                            dec.decode_attention_ref(q, k, v, lens), dtype)
                if name == "path":
                    path_err = err
                    if dtype == torch.bfloat16:
                        path_inputs = (q, k, v, lens)
            # a window inside the cache, read in place
            lo, hi = Skv // 3, Skv // 3 + Skv // 2
            lens = torch.full_like(ragged, hi - lo)
            o = dec.decode_attention(q, k[:, lo:hi], v[:, lo:hi], lens)
            copy = dec.decode_attention(q, k[:, lo:hi].contiguous(),
                                        v[:, lo:hi].contiguous(), lens)
            torch.cuda.synchronize()
            check(f"{list(case)} view [{lo}:{hi}]", o,
                  dec.decode_attention_ref(q, k[:, lo:hi], v[:, lo:hi], lens),
                  dtype, exact=copy)

    # the two scans at one step, as decode runs them (never launched at
    # S = 1 by the layer split): RecurrentGemma-9B's width, Mamba-2-780M's
    # heads with a chunk of one step
    one_step = []
    a = 0.8 + 0.199 * torch.rand((1, 1, 4096), generator=gen, device="cuda")
    b, h0 = normal(1, 1, 4096), normal(1, 4096)
    h = lru.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    err = float((h - lru.rglru_scan_ref(a, b, h0)).abs().max())
    one_step.append({"kernel": "rglru_scan", "shape": [1, 1, 4096],
                     "max_abs_err": err, "atol": RGLRU_ATOL})
    if not err <= RGLRU_ATOL:
        raise RuntimeError(f"rglru_scan at one step: max|d|={err}")
    x, dt = normal(1, 1, 48, 64), 0.001 + 0.099 * torch.rand(
        (1, 1, 48), generator=gen, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((48,), generator=gen, device="cuda"))
    Bm, Cm, st = normal(1, 1, 1, 128), normal(1, 1, 1, 128), normal(
        1, 48, 64, 128)
    y, fin = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=256, init_state=st)
    torch.cuda.synchronize()
    y_ref, fin_ref = ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, 256, st)
    y_err = float((y - y_ref).abs().max())
    fin_err = float((fin - fin_ref).abs().max())
    one_step.append({"kernel": "ssd_scan", "shape": [1, 1, 48, 64, 1, 128],
                     "y_max_abs_err": y_err, "final_max_abs_err": fin_err})
    if not (y_err <= SSD_Y_ATOL and fin_err <= SSD_FINAL_ATOL):
        raise RuntimeError(f"ssd_scan at one step: max|dy|={y_err}, "
                           f"max|dfinal|={fin_err}")

    # times at the path's shape and at RecurrentGemma-9B's decode shape
    q, k, v, lens = path_inputs
    B, Skv, Hq, Hkv, D = DECODE_PATH
    path_times = time_decode(q, k, v, lens)
    rg = rg_decode_inputs(gen)
    rg_err = check("RecurrentGemma-9B decode shape, window view", dec
                   .decode_attention(*rg), dec.decode_attention_ref(*rg),
                   torch.bfloat16)
    rg_times = time_decode(*rg)
    rg_times.update(max_abs_err=rg_err,
                    timed=f"one RecurrentGemma-9B decode layer: q (1, 1, 16, "
                          f"256) against the view [{RG_DECODE_VIEW[0]}:"
                          f"{RG_DECODE_VIEW[1]}] of a (1, {RG_DECODE_CACHE}, "
                          "1, 256) bf16 cache; median of 10 x "
                          f"{DECODE_TIMING_CALLS} calls, best of 2")
    entry = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:65",
        "launches": None,                     # filled in by decode_serve
        "max_abs_err": path_err,
        **{key: path_times[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "raw_launch_ms", "raw_launch_ms_turns")},
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True, "
                        "boolean length mask, transposed views)",
        "library_max_abs_err_vs_plain": path_times[
            "library_max_abs_err_vs_plain"],
        "timed": f"one Qwen2-7B decode layer, q ({B}, 1, {Hq}, {D}), cache "
                 f"({B}, {Skv}, {Hkv}, {D}) bf16, {DECODE_PATH_LENGTH} valid "
                 f"keys a sequence; median of 10 x {DECODE_TIMING_CALLS} "
                 "calls, best of 2. "
                 "raw_launch_ms is the C entry alone (output and scratch "
                 "allocated beforehand): the kernels' pace; ms is the "
                 "wrapper (checks, three torch.empty, one ctypes call): "
                 "what a caller pays",
        "bytes": path_times["bytes"], "flops": path_times["flops"],
        "split": path_times["split"],
        "rg_shape": rg_times,
    }
    emit("decode_kernels", checks=checks, one_step_scans=one_step,
         decode_attention=entry, before_ms=DECODE_BEFORE_MS)
    return entry


def decode_steps(params, cfg, tokens, cache, start: int, steps: int):
    """``steps`` teacher-forced decode steps from position ``start``
    (token ``tokens[:, t]`` at position t) through ``cache``, in place.
    Returns the last logits and each step's CUDA-event milliseconds."""
    from repro_torch.models import transformer as tr
    marks, logits = [], None
    for t in range(start, start + steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache, t,
                                       cfg)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return logits, [a.elapsed_time(b) for a, b in marks]


def prefill_decode(params, cfg, tokens, prompt: int, steps: int):
    """Prefill ``tokens[:, :prompt]`` into a cache of ``prompt + steps``
    rows, then ``steps`` teacher-forced decode steps; the launch counts
    set to 0 just before and read after each part.  Returns (last logits,
    cache, record)."""
    from repro_torch.models import transformer as tr
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = tr.prefill(params, {"tokens": tokens[:, :prompt]}, cfg,
                          pad_to=prompt + steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_launches = launch_counts()
    logits, step_ms = decode_steps(params, cfg, tokens, cache, prompt, steps)
    decode_s = time.perf_counter() - t1
    record = {
        "batch": int(tokens.shape[0]), "prompt": prompt, "steps": steps,
        "prefill_seconds": t1 - t0, "decode_seconds": decode_s,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "tokens_per_second": tokens.shape[0] * steps / decode_s,
        "launches": {"prefill": prefill_launches,
                     "decode": launches_since(prefill_launches)}}
    want = {"prefill": _layers_run(cfg, 0, cfg.num_groups()),
            "decode": _decode_step_launches(cfg, steps)}
    if record["launches"] != want:
        raise RuntimeError(f"prefill + decode launched {record['launches']}"
                           f", expected {want}")
    return logits, cache, record


def one_machine(params, cfg, tokens):
    """Last-token logits of the forward over all of ``tokens``.  An SSD
    model whose chunk does not divide the length (Mamba-2's 256 and 4112
    tokens) runs with the largest chunk that does (16): the chunked scan
    computes the same function at any chunk length."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    S = tokens.shape[1]
    if cfg.ssm is not None and S % cfg.ssm.chunk_size:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=math.gcd(S, cfg.ssm.chunk_size)))
    hidden, _, _ = tr.forward_hidden(params, {"tokens": tokens}, cfg,
                                     kernels=ops.kernel_registry())
    return tr.unembed(params, hidden[:, -1:], cfg)


def phase_model_decode(phase: str, cfg, params, prompts) -> None:
    """Request 0 of a layer-split model: its prompt prefilled into a cache
    of ``LM_SEQ + LM_DECODE_STEPS`` rows, then as many teacher-forced
    steps, in bf16 and in fp32, and the last MODEL_PROFILE_STEPS bf16
    steps once more under ``torch.profiler`` (each cache row rewritten;
    a recurrent state steps on).  The fp32 decode is held to the fp32
    one-machine forward over the same tokens; the bf16 distances are
    reported."""
    from repro_torch.serving.profile_split import profile_decode
    extra = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, LM_DECODE_STEPS)).astype(np.int32)
    tokens = torch.from_numpy(np.concatenate([prompts[:1], extra],
                                             axis=1)).cuda()
    logits, cache, record = prefill_decode(params, cfg, tokens, LM_SEQ,
                                           LM_DECODE_STEPS)
    record["cache_rows"] = LM_SEQ + LM_DECODE_STEPS
    profile = profile_decode(params, cfg, tokens, cache,
                             LM_SEQ + LM_DECODE_STEPS - MODEL_PROFILE_STEPS,
                             MODEL_PROFILE_STEPS)
    del cache
    launches = _decode_step_launches(cfg, MODEL_PROFILE_STEPS)
    if profile["device_seconds"] is None or profile[
            "wrapper_launches"] != launches:
        raise RuntimeError(f"{phase}: the profiled steps launched "
                           f"{profile['wrapper_launches']}, expected "
                           f"{launches}; device seconds "
                           f"{profile['device_seconds']}")
    V = cfg.vocab_size
    want = one_machine(params, cfg, tokens)
    params32 = _tree_map(lambda t: t.float(), params)
    logits32, cache32, record32 = prefill_decode(params32, cfg, tokens,
                                                 LM_SEQ, LM_DECODE_STEPS)
    del cache32
    want32 = one_machine(params32, cfg, tokens)
    del params32
    torch.cuda.empty_cache()
    for t in (logits, want, logits32, want32):
        if not bool(torch.isfinite(t[..., :V]).all()):
            raise RuntimeError(f"{phase}: non-finite logits")
    held = _rel_l2(logits32, want32, V)
    emit(phase, config=cfg.name, **record, profile=profile,
         fp32={k: record32[k] for k in ("prefill_seconds", "step_ms_median",
                                        "launches")},
         fp32_decode_vs_forward_rel_l2=held,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2,
         bf16_decode_vs_forward_rel_l2=_rel_l2(logits, want, V),
         bf16_decode_vs_fp32_forward_rel_l2=_rel_l2(logits, want32, V),
         bf16_forward_vs_fp32_forward_rel_l2=_rel_l2(want, want32, V))
    if not held <= DECODE_FP32_REL_L2:
        raise RuntimeError(f"{phase}: fp32 decode against the fp32 forward: "
                           f"relative L2 error of the logits {held} > "
                           f"{DECODE_FP32_REL_L2}")


def phase_decode_serve(entry: dict, flash_entry: dict):
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(DECODE_ARCH, DECODE_PARAMETERS,
                                        DECODE_PARAMETER_BYTES)
    if (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()) != tuple(
            DECODE_PATH[2:]):
        raise RuntimeError(f"{DECODE_ARCH}: heads and head_dim differ from "
                           f"the decode path's {DECODE_PATH}")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_LEN)).astype(
            np.int32)).cuda()
    V = cfg.vocab_size

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    logits, cache, record = prefill_decode(params, cfg, tokens,
                                           DECODE_PROMPT, DECODE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches = record["launches"]["decode"]["decode_attention"]
    if launches != cfg.num_layers * DECODE_STEPS:
        raise RuntimeError(f"decode attention launched {launches} times")
    entry["launches"] = launches
    flash_entry["qwen2_7b_prefill"]["launches"] = record["launches"][
        "prefill"]["flash_attention"]
    cache_bytes = _nbytes(cache)
    if cache_bytes != DECODE_CACHE_BYTES:
        raise RuntimeError(f"the cache holds {cache_bytes} B, the "
                           f"reference's {DECODE_CACHE_BYTES} B")

    # bf16: against the one-machine forward over the same 4160 tokens
    want = one_machine(params, cfg, tokens)
    if not bool(torch.isfinite(logits[..., :V]).all()):
        raise RuntimeError("non-finite decode logits")
    bf16 = _rel_l2(logits, want, V)

    # fp32, request 0: the decode through the kernel against the fp32
    # forward and against the same decode through the plain version
    params32 = _tree_map(lambda t: t.float(), params)
    tok0 = tokens[:1, :DECODE_PROMPT + DECODE_FP32_STEPS]
    _, c32 = tr.prefill(params32, {"tokens": tok0[:, :DECODE_PROMPT]}, cfg,
                        pad_to=tok0.shape[1])
    c32_plain = _tree_map(torch.clone, c32)
    counts = launch_counts()
    k32, _ = decode_steps(params32, cfg, tok0, c32, DECODE_PROMPT,
                          DECODE_FP32_STEPS)
    if launches_since(counts) != _decode_step_launches(cfg,
                                                       DECODE_FP32_STEPS):
        raise RuntimeError(f"fp32 decode launched {launches_since(counts)}")
    counts = launch_counts()
    with plain_versions("decode_attention"):
        p32, _ = decode_steps(params32, cfg, tok0, c32_plain, DECODE_PROMPT,
                              DECODE_FP32_STEPS)
    if launches_since(counts)["decode_attention"] != 0:
        raise RuntimeError("the plain fp32 decode launched the kernel")
    del c32, c32_plain
    f32 = one_machine(params32, cfg, tok0)
    del params32
    torch.cuda.empty_cache()
    fp32 = {"vs_forward_rel_l2": _rel_l2(k32, f32, V),
            "vs_plain_rel_l2": _rel_l2(k32, p32, V),
            "max_abs_err_vs_plain": float((k32[..., :V] - p32[..., :V])
                                          .abs().max()),
            "logits_rms": float(f32[..., :V].square().mean().sqrt())}

    # an int8 cache from empty: through the kernel, through the plain
    # version, and the same steps over a bf16 cache
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def from_empty(c):
        cache0 = tr.init_decode_cache(c, DECODE_BATCH, DECODE_INT8_STEPS,
                                      device="cuda")
        return decode_steps(params, c, tokens, cache0, 0,
                            DECODE_INT8_STEPS)[0]
    counts = launch_counts()
    k8 = from_empty(cfg8)
    if launches_since(counts) != _decode_step_launches(cfg,
                                                       DECODE_INT8_STEPS):
        raise RuntimeError(f"int8 decode launched {launches_since(counts)}")
    with plain_versions("decode_attention"):
        p8 = from_empty(cfg8)
    b16 = from_empty(cfg)
    int8 = {"kernel_vs_plain_rel_l2": _rel_l2(k8, p8, V),
            "vs_bf16_cache_rel_l2": _rel_l2(k8, b16, V),
            "plain_vs_bf16_cache_rel_l2": _rel_l2(p8, b16, V)}
    emit("decode_serve", **info, **record, cache_bytes=cache_bytes,
         peak_memory_bytes=peak, bf16_decode_vs_forward_rel_l2=bf16,
         limit_bf16_rel_l2=LM_PLAIN_REL_L2, fp32=fp32,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2, fp32_steps=DECODE_FP32_STEPS,
         int8=int8, int8_steps=DECODE_INT8_STEPS)
    for name, err, limit in (
            ("bf16 decode vs the bf16 forward", bf16, LM_PLAIN_REL_L2),
            ("fp32 decode vs the fp32 forward", fp32["vs_forward_rel_l2"],
             DECODE_FP32_REL_L2),
            ("fp32 decode, kernel vs plain version", fp32["vs_plain_rel_l2"],
             DECODE_FP32_REL_L2),
            ("int8-cache decode, kernel vs plain version",
             int8["kernel_vs_plain_rel_l2"], LM_PLAIN_REL_L2)):
        if not err <= limit:
            raise RuntimeError(f"{name}: relative L2 error of the logits "
                               f"{err} > {limit}")
    return cfg, params, tokens, cache


def phase_decode_profile(cfg, params, tokens, cache) -> None:
    """The last DECODE_PROFILE_STEPS positions of the main path decoded
    again through its cache (each row rewritten with what it held) under
    ``torch.profiler``."""
    from repro_torch.serving.profile_split import profile_decode
    start = DECODE_LEN - DECODE_PROFILE_STEPS
    out = profile_decode(params, cfg, tokens, cache, start,
                         DECODE_PROFILE_STEPS)
    if out["device_seconds"] is None:
        raise RuntimeError("the profiler recorded no device activity")
    want = _decode_step_launches(cfg, DECODE_PROFILE_STEPS)
    if out["wrapper_launches"] != want:
        raise RuntimeError(f"profiled decode launched "
                           f"{out['wrapper_launches']}, expected {want}")
    out["decode_attention_share"] = (
        out["by_class"].get("decode_attention", 0.0) / out["device_seconds"])
    emit("decode_profile", **out)


def phase_replay(params, cfg) -> None:
    """The paper's scheduler end to end: the port's fleet simulator
    records the golden workload's decision trace, every plan is
    re-derived from it, and the first REPLAY_RECORDS dispatch records run
    through a fresh full-width engine (cold cache, int8 wire) on the
    serve's weights.  At full width the engine's grid is the simulator's
    (50 iterations, stride 5): each record keeps its own key."""
    import tempfile
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.transport import LOCAL_LINK, wire_nbytes
    from repro_torch.kernels import int8_quant
    from repro_torch.serving.engine import DiffusionSplitEngine
    from repro_torch.serving.fleet_sim import SimConfig, run_fleet_sim
    from repro_torch.serving.replay import (read_trace,
                                            replay_through_engine,
                                            scaled_group_key,
                                            verify_decisions)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        sim = run_fleet_sim(SimConfig(trace_out=path, **REPLAY_CELL))
        trace = read_trace(path)
    decisions = verify_decisions(trace)
    if (decisions.n_plans, decisions.n_replans, len(decisions.mismatches),
            sim.n_arrivals) != (REPLAY_PLANS, 0, 0, REPLAY_PLANS):
        raise RuntimeError(f"decision trace: {decisions.to_json()}, "
                           f"{sim.n_arrivals} arrivals")
    sim_n_total = int(trace.header["planner"]["params"]["n_total"])
    records = trace.dispatches()[:REPLAY_RECORDS]
    keys = [scaled_group_key(r, sim_n_total, cfg.n_total_iterations,
                             cfg.split_stride) for r in records]
    if keys != [(r["n_final"], r["batch"]) for r in records]:
        raise RuntimeError(f"engine keys {keys} are not the records' own")

    cost = CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=5.0, k_decode=1.0)
    engine = DiffusionSplitEngine(params, cfg, cost, link=LOCAL_LINK,
                                  wire="int8", device="cuda")
    reset_launch_counts()
    int8_quant.launch_count = 0
    t0 = time.perf_counter()
    report = replay_through_engine(trace, engine=engine,
                                   max_records=REPLAY_RECORDS)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    int8_launches = int8_quant.launch_count
    others = launch_counts()

    latent = (cfg.latent_channels, cfg.latent_size, cfg.latent_size)
    context = (2, cfg.text_len, cfg.text_width)
    faults = []
    if report.executed != len(records):
        faults.append(f"executed {report.executed} of {len(records)}")
    if report.executable_bound != 11:
        faults.append(f"executable bound {report.executable_bound}")
    if report.measured_executables != report.modeled_executables:
        faults.append("executables: measured "
                      f"{report.measured_executables}, modeled "
                      f"{report.modeled_executables}")
    if report.measured_executables != len(set(keys)):
        faults.append(f"{report.measured_executables} executables for "
                      f"{len(set(keys))} keys")
    if report.measured_hit_rate != report.modeled_hit_rate:
        faults.append(f"hit rate: measured {report.measured_hit_rate}, "
                      f"modeled {report.modeled_hit_rate}")
    shipped = 0
    for g in report.groups:
        shapes = {"latent": latent}
        if g.n_scaled < cfg.n_total_iterations:
            shapes["context"] = context
        want = wire_nbytes(shapes, "int8")
        if not g.measured_bytes == g.modeled_bytes == want:
            faults.append(f"group {(g.n_scaled, g.batch)}: measured "
                          f"{g.measured_bytes} B, modeled "
                          f"{g.modeled_bytes} B, closed form {want} B")
        shipped += want * g.batch * g.executions
    if report.bytes_shipped != shipped or report.bytes_overhead != 0.0:
        faults.append(f"{report.bytes_shipped} B shipped, {shipped} B "
                      f"closed form")
    if report.requests != sum(r["batch"] for r in records):
        faults.append(f"{report.requests} requests served")
    if int8_launches != report.executed or any(others.values()):
        faults.append(f"int8 launched {int8_launches} times for "
                      f"{report.executed} dispatches; others {others}")
    if not all(math.isfinite(g.measured_s) and g.measured_s > 0
               for g in report.groups):
        faults.append("a group has no measured seconds")
    if faults:
        raise RuntimeError("replay: " + "; ".join(faults))
    del engine
    emit("replay", workload=REPLAY_CELL, arrivals=sim.n_arrivals,
         trace_records=len(trace.records),
         decisions={"plans": decisions.n_plans,
                    "replans": decisions.n_replans,
                    "mismatches": len(decisions.mismatches)},
         dispatches=report.n_dispatches, executed=report.executed,
         skipped=report.skipped,
         executables={"modeled": report.modeled_executables,
                      "measured": report.measured_executables,
                      "bound": report.executable_bound},
         hit_rate={"modeled": report.modeled_hit_rate,
                   "measured": report.measured_hit_rate},
         gpu_seconds=report.gpu_seconds,
         compile_seconds=report.compile_seconds,
         bytes_shipped=report.bytes_shipped, requests=report.requests,
         calibration_ratio=report.calibration_ratio,
         max_rel_dev=report.max_rel_dev,
         groups=[{"n_scaled": g.n_scaled, "batch": g.batch,
                  "executions": g.executions, "measured_s": g.measured_s,
                  "modeled_s": g.modeled_s,
                  "payload_bytes": g.measured_bytes}
                 for g in report.groups],
         int8_launches=int8_launches, replay_seconds=replay_s,
         seconds=time.perf_counter() - t_phase)


def phase_regnet() -> None:
    """RegNet-Y-128GF at full width on the card: the forward of one
    384 x 384 image, and at each split point of paper Table 1 the cloud's
    half, the activation through the host (the shipped bytes) and the
    device's half, held to the forward; then each segment and the forward
    timed at batch 1 and 8.  Its convolutions are cuDNN's (fp32, TF32
    off): no hand kernel is on this path."""
    from repro_torch.configs import regnet_y_128gf
    from repro_torch.convert import tree_map
    from repro_torch.models import regnet
    cfg = regnet_y_128gf.CONFIG
    t_phase = time.perf_counter()
    reset_launch_counts()
    params = regnet.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if (n_params, n_bytes) != (REGNET_PARAMETERS, REGNET_PARAMETER_BYTES):
        raise RuntimeError(f"RegNet: {n_params} parameters in {n_bytes} B")
    table = regnet.split_activations(cfg)
    if {name: b for name, _, b in table} != REGNET_TABLE1_BYTES:
        raise RuntimeError(f"split_activations {table}")

    torch.cuda.reset_peak_memory_stats()
    size = cfg.image_size
    images = torch.randn((max(REGNET_BATCHES), 3, size, size),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED), device="cuda")
    logits = regnet.forward(params, cfg, images[:1])
    if (tuple(logits.shape) != (1, cfg.num_classes)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"logits {tuple(logits.shape)}, finite "
                           f"{bool(torch.isfinite(logits).all())}")
    scale = float(logits.abs().max())
    limit = REGNET_SPLIT_RTOL * scale
    splits = []
    for name, shape, nbytes in table:
        act = regnet.run_from(params, cfg, images[:1], "input", name)
        shipped = act.cpu()
        if (tuple(shipped.shape) != shape
                or shipped.numel() * shipped.element_size() != nbytes):
            raise RuntimeError(f"{name}: activation {tuple(shipped.shape)}")
        out = regnet.run_from(params, cfg, shipped.to("cuda"), name,
                              "logits")
        err = float((out - logits).abs().max())
        if not err <= limit:
            raise RuntimeError(f"split at {name}: logits off by {err} > "
                               f"{limit}")
        splits.append({"point": name, "shape": list(shape),
                       "bytes": nbytes, "max_abs_err": err})

    order = ("input",) + regnet.SPLIT_POINTS + ("logits",)
    timings = []
    for B in REGNET_BATCHES:
        x = images[:B]
        segments = {}
        for start, stop in zip(order, order[1:]):
            nxt = regnet.run_from(params, cfg, x, start, stop)
            segments[stop] = time_ms(
                lambda x=x, start=start, stop=stop:
                regnet.run_from(params, cfg, x, start, stop),
                inner=1, samples=5)
            x = nxt
        if B > 1:
            # image 0 alone and in the batch: the same logits
            err = float((x[:1] - logits).abs().max())
            if not err <= limit:
                raise RuntimeError(f"batch {B}: image 0's logits off by "
                                   f"{err} > {limit}")
        fwd_ms = time_ms(lambda B=B: regnet.forward(params, cfg, images[:B]),
                         inner=1, samples=5)
        timings.append({
            "batch": B, "forward_ms": fwd_ms, "segments_ms": segments,
            "tflop_per_s": REGNET_FLOPS_PER_IMAGE * B / fwd_ms / 1e9,
            "fp32_peak_share": (REGNET_FLOPS_PER_IMAGE * B / (fwd_ms / 1e3)
                                / FP32_FLOP_PER_S)})
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"hand kernels launched on RegNet's path: "
                           f"{launches}")
    del params
    emit("regnet", config=cfg.name, parameters=n_params,
         parameter_bytes=n_bytes, init_seconds=init_s,
         image_size=size, logit_scale=scale, split_rtol=REGNET_SPLIT_RTOL,
         splits=splits, timings=timings,
         flops_per_image=REGNET_FLOPS_PER_IMAGE, peak_memory_bytes=peak,
         seconds=time.perf_counter() - t_phase)


#: the keys of a kernel in the kernels line: this run's measurements, its
#: launches on the main path and its bound; the phase lines carry the rest
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")


def kernels_line(*entries) -> list:
    """Each kernel's entry cut to KERNEL_LINE_KEYS; raises if one lacks a
    key or was launched no time on the main path."""
    line = []
    for e in entries:
        missing = [k for k in KERNEL_LINE_KEYS if k not in e]
        if missing or not e["launches"]:
            raise RuntimeError(f"{e.get('name')}: missing {missing} or "
                               f"launched {e.get('launches')} times")
        line.append({k: e[k] for k in KERNEL_LINE_KEYS})
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    with torch.inference_mode():
        smi = phase_env()
        phase_build()
        kernel_entry = phase_kernels()
        served = phase_serve(kernel_entry)
        phase_device(*served)
        phase_replay(served[0], served[1])
        del served
        torch.cuda.empty_cache()
        lm_entries = phase_lm_kernels()
        cloud, device, prompts = phase_lm_serve(lm_entries)
        phase_lm_profile(cloud, device, prompts)
        phase_model_decode("lm_decode", cloud.cfg, cloud.params, prompts)
        del cloud, device
        gc.collect()                 # RecurrentGemma's 15 GB of weights
        torch.cuda.empty_cache()
        ssd_entry = phase_ssd_kernels()
        phase_model_decode("mamba_decode", *phase_mamba_serve(ssd_entry))
        gc.collect()                 # Mamba-2's 1.7 GB of weights
        torch.cuda.empty_cache()
        decode_entry = phase_decode_kernels()
        phase_decode_profile(*phase_decode_serve(
            decode_entry, lm_entries["flash_attention"]))
        gc.collect()                 # Qwen2-7B's 15 GB of weights
        torch.cuda.empty_cache()
        phase_regnet()
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels_line(
        kernel_entry, lm_entries["flash_attention"], lm_entries["rglru_scan"],
        ssd_entry, decode_entry)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
