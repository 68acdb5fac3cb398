"""The int8 boundary quantiser of one or more source trees of the port, on
one card, in turns.

    python3 quant_ab.py --tree parent=DIR --tree change=. \
        [--rounds 2] [--out chiprun_out/quant_ab.jsonl]

Each tree is a checkout of the repo.  Each arm runs in a process of its
own with that tree's ``src`` first on the path, so it builds and loads
that tree's kernels; one round runs the arms in the order given and the
next in the reverse order (A B B A for two).  Every input is drawn from
``--seed`` on the card, at Stable-Diffusion-v1's boundary: a request's
latent (4, 64, 64) and context (2, 77, 768), fp32.  An arm measures:

- ``per_shape``: ``int8_quantize`` at (4, 4096) and (2, 59136): the
  wrapper's ms a call and the C entry's alone (outputs allocated
  beforehand), CUDA-event medians, and the device time of its kernel
  launches in ``torch.profiler``;
- ``groups``: a group's latent (B·4, 4096), and its context (2B, 59136)
  where the group ends before the last iteration, through the tree's
  wrappers (one ``int8_quantize_group`` call where the tree has it, else
  one ``int8_quantize`` call a tensor of each request): ms a group, the
  quantiser's launches and device time a group;
- ``encode``: the same group as the tree's ``DiffusionSplitEngine``
  turns it into int8 payloads, from the tensors on the card to the bytes
  on the host (a tree with ``_encode_int8_group`` calls it; an older one
  takes its ``process_group``'s steps: both tensors to the host in fp32,
  then ``pack_boundary_wire`` a request with the engine's ``rowwise``
  hook): the host's ms a group, and the launches and copies between host
  and card in one profiled group; a digest of the payloads, equal in
  every arm or the run fails;
- ``empty_launch`` (a tree whose library has ``repro_int8_empty_launch``):
  a launch with no work on each group's grid and cluster.

Each arm prints one JSON line, also appended to ``--out``.  Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

#: (requests, with context): the serve's groups are a mid group of one
#: request and an end group of seven (no context)
GROUPS = ((1, True), (3, True), (8, True), (7, False))


def time_ms(torch, fn, inner: int = 50, samples: int = 20) -> float:
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


def traced(torch, fn, calls: int) -> dict:
    """``fn`` called ``calls`` times under ``torch.profiler``: per call,
    the launches and device µs of the int8 kernels and of the empty
    kernel, and the copies by kind with their bytes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {"int8_launches": 0, "int8_us": 0.0, "empty_launches": 0,
           "empty_us": 0.0, "copies": {}}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel" and "int8_quantize" in e["name"]:
            out["int8_launches"] += 1
            out["int8_us"] += e["dur"]
        elif e.get("cat") == "kernel" and "int8_empty" in e["name"]:
            out["empty_launches"] += 1
            out["empty_us"] += e["dur"]
        elif e.get("cat") == "gpu_memcpy":
            c = out["copies"].setdefault(e["name"], {"n": 0, "bytes": 0,
                                                     "us": 0.0})
            c["n"] += 1
            c["bytes"] += int(e.get("args", {}).get("bytes", 0))
            c["us"] += e["dur"]
    for key in ("int8_launches", "int8_us", "empty_launches", "empty_us"):
        out[key] /= calls
    for c in out["copies"].values():
        for key in c:
            c[key] /= calls
    return out


def group_c_entry(lib, int8_quant, segs, buf, stream):
    """A call of the grouped C entry alone on ``segs`` into ``buf``, its
    table made beforehand."""
    shapes = [tuple(x.shape) for x in segs]
    s_offs, q_offs, _ = int8_quant.group_layout(shapes)
    n = len(segs)
    table = [(ctypes.c_void_p * n)(*(x.data_ptr() for x in segs))] + [
        (ctypes.c_longlong * n)(*col) for col in (
            [T for T, _ in shapes], [d for _, d in shapes], q_offs, s_offs)]
    return lambda: lib.repro_int8_quantize_group(*table, n, buf.data_ptr(),
                                                 stream)


def worker(args) -> dict:
    import torch
    sys.path[:0] = [os.path.join(args.dir, "src"), args.dir]
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from repro_torch.configs import stable_diffusion_v1
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.transport import (get_wire_format,
                                            pack_boundary_wire)
    from repro_torch.kernels import _build, int8_quant
    from repro_torch.serving.engine import DiffusionSplitEngine

    t0 = time.perf_counter()
    lib = _build.load_library()
    build_s = time.perf_counter() - t0
    grouped = hasattr(int8_quant, "int8_quantize_group")
    stream = torch.cuda.current_stream().cuda_stream
    cfg = stable_diffusion_v1.CONFIG
    C, S = cfg.latent_channels, cfg.latent_size
    L, Wd = cfg.text_len, cfg.text_width
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 3.0

    per_shape = []
    for T, d in ((C, S * S), (2, L * Wd)):
        x = randn(T, d)
        if grouped:
            raw = group_c_entry(lib, int8_quant, [x],
                                int8_quant.int8_quantize_group([x]), stream)
        else:
            q, s = int8_quant.int8_quantize(x)

            def raw():
                return lib.repro_int8_quantize_rows(
                    x.data_ptr(), q.data_ptr(), s.data_ptr(), T, d, stream)
        trace = traced(torch, lambda: int8_quant.int8_quantize(x), 20)
        per_shape.append({
            "shape": [T, d],
            "ms": time_ms(torch, lambda: int8_quant.int8_quantize(x)),
            "raw_launch_ms": time_ms(torch, raw),
            "launches": trace["int8_launches"],
            "device_us": trace["int8_us"]})

    cost = CostParams(r_cloud=40.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=3.0, k_decode=1.0)
    wire = get_wire_format("int8")
    engine = DiffusionSplitEngine(None, cfg, cost, wire=wire.name,
                                  device="cuda")
    groups, encode, empty = [], [], []
    for B, with_ctx in GROUPS:
        lat = randn(B, C, S, S)
        ctx2 = randn(2, B, L, Wd) if with_ctx else None
        segs = [lat.reshape(B * C, S * S)]
        if with_ctx:
            segs.append(ctx2.reshape(2 * B, L * Wd))
        if grouped:
            def quantise():
                return int8_quant.int8_quantize_group(segs)

            def encode_group():
                return engine._encode_int8_group(lat, ctx2, wire)
        else:
            # one call a tensor of each request, as the engine made them
            tensors = [lat[i].reshape(C, S * S) for i in range(B)]
            if with_ctx:
                tensors += [ctx2[:, i].contiguous().reshape(2, L * Wd)
                            for i in range(B)]

            def quantise():
                return [int8_quant.int8_quantize(x) for x in tensors]

            def encode_group():
                # the older process_group: fp32 to the host, then
                # pack_boundary_wire a request through the rowwise hook
                lat_np = lat.float().cpu().numpy()
                ctx_np = ctx2.float().cpu().numpy() if with_ctx else None
                return [pack_boundary_wire(
                    lat_np[i], ctx_np[:, i] if with_ctx else None, wire,
                    rowwise=engine._rowwise) for i in range(B)]
        trace = traced(torch, quantise, 20)
        groups.append({"requests": B, "context": with_ctx,
                       "ms": time_ms(torch, quantise),
                       "launches": trace["int8_launches"],
                       "device_us": trace["int8_us"]})
        payloads = encode_group()
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_group()
            host.append((time.perf_counter() - t0) * 1e3)
        trace = traced(torch, encode_group, 5)
        encode.append({
            "requests": B, "context": with_ctx,
            "host_ms": statistics.median(host), "host_ms_all": host,
            "launches": trace["int8_launches"], "device_us": trace["int8_us"],
            "copies": trace["copies"],
            "payload_bytes": sum(len(p) for p in payloads),
            "digest": hashlib.sha256(b"".join(payloads)).hexdigest()})
        if hasattr(lib, "repro_int8_empty_launch"):
            rows = sum(x.shape[0] for x in segs)
            max_d = max(x.shape[1] for x in segs)

            def launch_empty():
                return lib.repro_int8_empty_launch(rows, max_d, stream)
            trace = traced(torch, launch_empty, 20)
            empty.append({"requests": B, "context": with_ctx,
                          "raw_launch_ms": time_ms(torch, launch_empty),
                          "device_us": trace["empty_us"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    return {"tree": args.name, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "build_seconds": build_s, "grouped": grouped,
            "per_shape": per_shape, "groups": groups, "encode": encode,
            "empty_launch": empty}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR; one or more")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    # one arm, run by the parent process
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("quant_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.worker:
        with torch.inference_mode():
            print(json.dumps(worker(args)), flush=True)
        return 0
    if not args.tree:
        ap.error("give one tree or more")
    arms = []
    for spec in args.tree:
        name, _, path = spec.partition("=")
        arms.append((name, os.path.abspath(path)))
    digests = set()
    for r in range(args.rounds):
        for name, path in (arms if r % 2 == 0 else arms[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   "--name", name, "--dir", path, "--seed", str(args.seed)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"arm {name} failed ({proc.returncode})")
            line = proc.stdout.strip().splitlines()[-1]
            rec = dict(json.loads(line), round=r)
            digests.add(tuple(e["digest"] for e in rec["encode"]))
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    if len(digests) != 1:
        raise RuntimeError(f"the arms' payloads differ: {digests}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
