"""Serving launcher: the paper's split-serving engine behind a CLI.

`python -m repro_torch.launch.serve --requests 16 --t-lim 3.0` builds the
reduced diffusion model (`--full-width`: the full Stable-Diffusion-v1
config), generates a mixed device fleet, schedules each request (minimum
cloud iterations for its SLA, quantized to the n_step grid), runs the
batched cloud segments, ships boundaries through the transport model, and
completes every job on the simulated device.  It runs on the GPU unless
`--device cpu` is given; without a GPU it stops with an error.
"""
import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import stable_diffusion_v1
from repro_torch.core.cost_model import CostParams
from repro_torch.core.telemetry import generate_fleet
from repro_torch.core.transport import LOCAL_LINK, WAN_LINK, WIRE_FORMATS
from repro_torch.models import diffusion
from repro_torch.serving.engine import (
    DiffusionDeviceSim,
    DiffusionSplitEngine,
    Request,
)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--t-lim", type=float, default=3.0)
    ap.add_argument("--r-cloud", type=float, default=40.0)
    ap.add_argument("--fleet-mean", type=float, default=2.25)
    ap.add_argument("--fleet-std", type=float, default=0.8)
    ap.add_argument("--wan", action="store_true")
    ap.add_argument("--int8-transport", action="store_true",
                    help="legacy affine int8 payloads (numpy, no kernel)")
    ap.add_argument("--wire", choices=sorted(WIRE_FORMATS), default=None,
                    help="wire format of the boundary; int8 and int8_zlib "
                         "quantise through the CUDA kernel on a GPU")
    ap.add_argument("--full-width", action="store_true",
                    help="the full Stable-Diffusion-v1 config, not the "
                         "reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (required)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (stable_diffusion_v1.CONFIG if args.full_width
           else stable_diffusion_v1.reduced())
    params = diffusion.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cost = CostParams(r_cloud=args.r_cloud, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=args.t_lim,
                      k_decode=1.0)
    link = WAN_LINK if args.wan else LOCAL_LINK
    engine = DiffusionSplitEngine(
        params, cfg, cost, link=link,
        transfer_mode="int8" if args.int8_transport else "paper",
        wire=args.wire, device=dev)
    device = DiffusionDeviceSim(params, cfg, device=dev)
    fleet = generate_fleet(args.requests, args.fleet_mean, args.fleet_std,
                           seed=args.seed, rtt=link.rtt)
    toks = np.zeros((1, cfg.text_len), np.int32)
    reqs = [Request(d.device_id, d, toks, toks) for d in fleet]
    results = engine.serve(reqs, seed=args.seed)

    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    print(f"{'request':10s} {'r_dev':>6s} {'n_cloud':>8s} {'payload':>9s} "
          f"{'t_net':>8s}")
    for d in fleet:
        r = results[d.device_id]
        img = device.complete(r)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"{d.device_id}: non-finite image")
        print(f"{d.device_id:10s} {d.r_dev:6.2f} {r.n_cloud:8d} "
              f"{len(r.payload):8d}B {r.transfer_seconds*1e3:7.2f}ms")
    print(f"\nengine stats: {engine.stats}")
    print(f"distinct executables (bounded by n_total/n_step + 1 = "
          f"{cfg.n_total_iterations // cfg.split_stride + 1}): "
          f"{engine.stats['executables']}")


if __name__ == "__main__":
    main()
