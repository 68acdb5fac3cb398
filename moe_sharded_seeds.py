"""OLMoE-1B-7B's Mixture-of-Experts over a mesh of 4 gloo ranks on one
card (``chip_smoke.py``'s ``moe_sharded``), on several token seeds.

    python3 moe_sharded_seeds.py [--seeds 6] \
        [--out chiprun_out/moe_sharded_seeds.jsonl]

Builds the kernels and draws the full-width OLMoE-1B-7B tree as
``chip_smoke.py`` does (weights from its ``SEED``), then runs the phase's
forwards and checks with the tokens drawn from ``SEED + 4``, ``SEED + 5``,
and on.  Each run prints the phase's JSON line (among its fields, the last
hidden's relative L2 to the one-process forward and each layer's, a rank
and a mesh, and the checks that failed), also appended to ``--out``; then
one line of the distances' range over the seeds.  The distances set the
phase's limits.  Exits 1 if a check failed on any seed.  Needs one NVIDIA
GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default="chiprun_out/moe_sharded_seeds.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_sharded_seeds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    failed, runs = {}, []
    with torch.inference_mode():
        print(cs.phase_env(), flush=True)
        cs.phase_build()
        cfg, params, _ = cs.init_full_width(
            cs.MOE_ARCH, cs.MOE_PARAMETERS, cs.MOE_PARAMETER_BYTES)
        for seed in range(cs.SEED + 4, cs.SEED + 4 + args.seeds):
            lines = []
            real_emit = cs.emit

            def emit(phase, **fields):
                lines.append({"phase": phase, **fields})
                real_emit(phase, **fields)
            cs.emit = emit
            try:
                failed[seed] = cs.moe_sharded(cfg, params, seed)
            finally:
                cs.emit = real_emit
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                for line in lines:
                    f.write(json.dumps(line) + "\n")
            runs += [line for line in lines if line["phase"] == "moe_sharded"]
    summary = {}
    for key in ("rel_l2_max", "layer_rel_l2_max",
                "one_process_as_ranks_rel_l2"):
        values = [m[key] for run in runs for m in run["meshes"].values()]
        summary[key] = [min(values), max(values)]
    print(json.dumps({"phase": "moe_sharded_seeds", "seeds": sorted(failed),
                      "range": summary,
                      "failed": {s: f for s, f in failed.items() if f}}),
          flush=True)
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
