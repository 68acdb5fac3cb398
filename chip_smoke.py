#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path once at the full width of the Stable-Diffusion-v1
config: a split-serving engine answers 8 requests with int8 boundary
payloads, and the device side completes one request of each group.

Each phase prints one JSON line.  The line before the last two is
``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises: the exit code
is then non-zero and no result line is printed.  There is no CPU mode.
"""
from __future__ import annotations

import json
import os
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

MAIN_PATH_SHAPES = ((4, 4096), (2, 59136))     # latent, context per request
RAGGED_SHAPES = ((509, 256), (1, 8), (130, 64))
N_REQUESTS = 8
SEED = 0
# Images lie in [-1, 1]; the split run and the one-machine run do the same
# fp32 arithmetic on the same card, so they should agree far inside this.
SPLIT_ATOL = 1e-3


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


def phase_build() -> None:
    from repro_torch.kernels import _build
    info = _build.build_library()
    _build.load_library()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=info.seconds, compiled=info.compiled,
         sources=info.sources, ptxas=ptxas)
    if not info.compiled:
        raise RuntimeError("the kernel library was not built in this run")


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


def phase_kernels() -> dict:
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
        checks.append({"shape": list(shape), "q_max_abs_err": q_err,
                       "s_ulp": s_ulp, "equal_to_numpy": host_equal})
        max_err = max(max_err, float(q_err), s_err)
        if q.shape != x.shape or s.shape != (shape[0], 1):
            raise RuntimeError(f"int8_quantize{shape}: wrong output shapes")
        if q_err != 0 or s_ulp > 1:
            raise RuntimeError(
                f"int8_quantize{shape} disagrees with its plain version: "
                f"max|dq|={q_err}, scales differ by {s_ulp} ulp")
        if not host_equal:
            raise RuntimeError(
                f"int8_quantize{shape} disagrees with numpy on the host")
        if ties_row_wrong(q, x):
            raise RuntimeError(f"int8_quantize{shape}: ties not to even")

    def one_request(fn):
        return lambda: [fn(inputs[sh]) for sh in MAIN_PATH_SHAPES]

    # kernel and plain version in turns, on this one card
    plain_a = time_ms(one_request(int8_quant.int8_quantize_ref))
    kern_a = time_ms(one_request(int8_quant.int8_quantize))
    kern_b = time_ms(one_request(int8_quant.int8_quantize))
    plain_b = time_ms(one_request(int8_quant.int8_quantize_ref))
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    per_shape = []
    for sh in MAIN_PATH_SHAPES:
        b_ms, _, nbytes = int8_bound([sh])
        x = inputs[sh]
        q, s = int8_quant.int8_quantize(x)

        def raw_launch():
            # the C entry point alone, outputs allocated beforehand: what
            # is left of "ms" once the wrapper's host work is taken out
            return lib.repro_int8_quantize_rows(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), sh[0], sh[1],
                stream)
        per_shape.append({
            "shape": list(sh), "bytes": nbytes, "bound_ms": b_ms,
            "ms": time_ms(lambda: int8_quant.int8_quantize(x)),
            "raw_launch_ms": time_ms(raw_launch),
            "plain_ms": time_ms(lambda: int8_quant.int8_quantize_ref(x))})
    bound_ms, bound_by, _ = int8_bound(MAIN_PATH_SHAPES)
    entry = {
        "name": "int8_quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
        "replaces": "src/repro/kernels/int8_quant.py:30",
        "launches": None,                      # filled in by the serve phase
        "max_abs_err": max_err,
        # one request's boundary: the latent and the context, two launches
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "timed": "wrapper calls, latent (4,4096) + context (2,59136), "
                 "inputs warm in L2; median of 20 x 50 calls, best of 2",
        "per_shape": per_shape,
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

    torch.cuda.reset_peak_memory_stats()
    int8_quant.launch_count = 0
    t0 = time.perf_counter()
    results = engine.serve(reqs, seed=SEED)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = int8_quant.launch_count

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
    expected = 0
    for res in results.values():
        mid = res.n_cloud < n_total
        expected += 2 if mid else 1
        want = wire_nbytes(shapes_mid if mid else shapes_end, "int8")
        if len(res.payload) != want:
            raise RuntimeError(f"{res.request_id}: payload of "
                               f"{len(res.payload)} B, expected {want} B")
    if launches <= 0 or launches != expected:
        raise RuntimeError(f"int8 kernel launched {launches} times on the "
                           f"serving path, expected {expected}")
    kernel_entry["launches"] = launches
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
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return params, cfg, cost, link, results, groups


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    with torch.inference_mode():
        smi = phase_env()
        phase_build()
        kernel_entry = phase_kernels()
        served = phase_serve(kernel_entry)
        phase_device(*served)
    print(json.dumps({"kernels": [kernel_entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
