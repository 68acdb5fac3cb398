"""Decode steps of one full-width model through several source trees of
the port, on one card, in turns.

    python3 decode_ab.py --tree parent=DIR --tree change=. \
        [--arch mamba2-780m] [--rounds 2] [--out chiprun_out/decode_ab.jsonl]

Each tree is a checkout of the repo.  Each arm runs in a process of its
own with that tree's ``src`` first on the path, so it builds and loads
that tree's kernels; one round runs the arms in the order given and the
next in the reverse order (A B B A for two).  An arm prefills one prompt
of ``--prompt`` random tokens (weights drawn from ``--seed``), then
measures:

- ``--steps`` teacher-forced decode steps: each step's CUDA-event
  milliseconds and the host's milliseconds a step;
- ``--profile-steps`` more under ``torch.profiler``, through the tree's
  ``serving/profile_split.profile_decode``: device busy time, device
  time by kernel class, idle share;
- the SSD wrapper alone at the decode shape (one step, with a state):
  the host's microseconds a call and the device's, over ``--calls``
  calls.

A tree given as ``NAME=DIR:phases`` sends every SSD call, decode steps
included, through the three phases (chunk states, state pass, chunk
outputs), by handing the C entry scratch.
Each arm prints one JSON line, also appended to ``--out``.  Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _phases_wrapper(ssd):
    """``ssd.ssd_scan`` sent through the three phases at every length
    (``chip_smoke.ssd_three_phases``), counted as the wrapper counts."""
    from chip_smoke import ssd_three_phases

    def ssd_scan(x, dt, A, Bm, Cm, *, chunk_size, init_state=None):
        out = ssd_three_phases(x, dt, A, Bm, Cm, min(chunk_size, x.shape[1]),
                               init_state)
        ssd.launch_count += 1
        ssd.kernel_count += 3
        return out
    return ssd_scan


def worker(args) -> dict:
    import numpy as np
    import torch
    sys.path[:0] = [os.path.join(args.dir, "src"), args.dir]
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as tr
    from repro_torch.serving.profile_split import profile_decode

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    if args.phases:
        ssd.ssd_scan = _phases_wrapper(ssd)
    cfg = get_config(args.arch)
    params = tr.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed), "cuda")
    total = args.prompt + args.steps + args.profile_steps
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (1, total)).astype(np.int32)).cuda()
    _, cache = tr.prefill(params, {"tokens": tokens[:, :args.prompt]}, cfg,
                          pad_to=total)
    torch.cuda.synchronize()

    marks = []
    t0 = time.perf_counter()
    for t in range(args.prompt, args.prompt + args.steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache, t,
                                       cfg)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3
    step_ms = [a.elapsed_time(b) for a, b in marks]
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    profile = profile_decode(params, cfg, tokens, cache,
                             args.prompt + args.steps, args.profile_steps)
    del cache, params

    out = {"tree": args.name, "phases": args.phases, "arch": cfg.name,
           "device": torch.cuda.get_device_name(0), "build_seconds": build_s,
           "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
           "host_step_ms": host_ms,
           "profile": {k: profile.get(k) for k in (
               "step_ms_host", "device_seconds", "busy_seconds",
               "by_class", "kernels_in_trace", "idle_share",
               "wrapper_launches")}}
    if cfg.ssm is not None:
        s = cfg.ssm
        H, P, G, N = (s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                      s.d_state)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        x = torch.randn((1, 1, H, P), generator=gen, device="cuda")
        dt = 0.001 + 0.099 * torch.rand((1, 1, H), generator=gen,
                                        device="cuda")
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
        Bm, Cm = (torch.randn((1, 1, G, N), generator=gen, device="cuda")
                  for _ in range(2))
        st = torch.randn((1, H, P, N), generator=gen, device="cuda")

        def call():
            return ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=s.chunk_size,
                                init_state=st)
        for _ in range(100):
            call()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(args.calls):
            call()
        b.record()
        host_us = (time.perf_counter() - t0) / args.calls * 1e6
        torch.cuda.synchronize()
        out["ssd_decode_call"] = {
            "shape": [1, 1, H, P, G, N], "calls": args.calls,
            "host_us": host_us,
            "device_us": a.elapsed_time(b) / args.calls * 1e3}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR or NAME=DIR:phases; two or more")
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    # one arm, run by the parent process
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--phases", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("decode_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.worker:
        with torch.inference_mode():
            print(json.dumps(worker(args)), flush=True)
        return 0
    if len(args.tree) < 2:
        ap.error("give two trees or more")
    arms = []
    for spec in args.tree:
        name, _, path = spec.partition("=")
        path, _, mode = path.partition(":")
        arms.append((name, os.path.abspath(path), mode == "phases"))
    common = ["--arch", args.arch, "--prompt", str(args.prompt), "--steps",
              str(args.steps), "--profile-steps", str(args.profile_steps),
              "--calls", str(args.calls), "--seed", str(args.seed)]
    for r in range(args.rounds):
        for name, path, phases in (arms if r % 2 == 0 else arms[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   "--name", name, "--dir", path, *common]
            if phases:
                cmd.append("--phases")
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"arm {name} failed ({proc.returncode})")
            line = proc.stdout.strip().splitlines()[-1]
            rec = dict(json.loads(line), round=r)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
