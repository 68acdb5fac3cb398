"""§Perf hillclimbing: count a cell under a named variant, and report
the three roofline terms (H100) in the reference's record.

The reference (``repro/launch/perf.py``) lowers the cell through XLA
under each variant; the port counts its own step
(``launch.dryrun.count_cell``) with the variant's change applied.

Variants (selected with --variant, composable with '+'):
  baseline       registry config, the port's step (one microbatch)
  int8_kv        decode KV cache stored int8 (+per-row scales)
  flash_vmem     accounting variant: the kernels' interiors stay on chip
                 and only their HBM inputs and outputs count -- the
                 port's default accounting, so it changes nothing and
                 the record says so
  micro<N>       train step over N microbatches, gradients accumulated
  microloss      the microbatches under one checkpoint, gradients
                 summed in the backward pass (with micro<N>)
  bf16grads      the accumulator in bf16 (with micro<N>)

A variant that would change nothing in the cell raises, and says why.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-7b \\
        --cell decode_32k --variant int8_kv --out perf.jsonl
"""
import argparse
import dataclasses
import json
import time
from typing import Dict, Tuple

from repro_torch.configs import cell_by_name, get_config
from repro_torch.launch.dryrun import (KERNEL_IO, MESH, count_cell,
                                       param_shapes, record_of)

#: why each variant can leave a cell unchanged
WHY_NOT = {
    "int8_kv": "only a decode step reads an attention KV cache",
    "micro": "only a train step has microbatches, and one is the "
             "baseline",
    "microloss": "the loss mode differs only over more than one "
                 "microbatch of a train step (compose with micro<N>)",
    "bf16grads": "the accumulator exists only over more than one "
                 "microbatch of a train step in the accumulating mode "
                 "(compose with micro<N>)",
}


def apply_variants(cfg, variants) -> Tuple[object, Dict]:
    """(config, count_cell keywords) of a '+'-split variant list; raises
    on an unknown variant."""
    kw: Dict = {}
    for v in variants:
        if v in ("baseline", "flash_vmem"):
            continue
        elif v == "int8_kv":
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        elif v == "microloss":
            kw["micro_mode"] = "loss"
        elif v == "bf16grads":
            kw["grad_acc_bytes"] = 2
        elif v.startswith("micro") and v[len("micro"):].isdigit():
            kw["n_micro"] = int(v[len("micro"):])
        else:
            raise SystemExit(f"unknown variant {v!r}")
    return cfg, kw


def perf_record(arch: str, cell_name: str, variant: str = "baseline"):
    """The record of ``arch`` at ``cell_name`` under ``variant``."""
    variants = variant.split("+")
    base = get_config(arch)
    cell = cell_by_name(cell_name)
    t0 = time.time()
    cfg, kw = apply_variants(base, variants)
    params = param_shapes(cfg)
    count = count_cell(cfg, cell, params=params, **kw)
    for v in variants:
        if v in ("baseline", "flash_vmem"):
            continue
        rest = [u for u in variants if u != v]
        cfg_r, kw_r = apply_variants(base, rest)
        if count_cell(cfg_r, cell, params=param_shapes(cfg_r),
                      **kw_r) == count:
            key = "micro" if v.startswith("micro") and v not in WHY_NOT \
                else v
            raise ValueError(f"variant {v!r} changes nothing in {arch} "
                             f"{cell_name}: {WHY_NOT[key]}")
    rec = record_of(arch, cell, count, cfg, time.time() - t0, params)
    # the reference's useful-FLOPs ratio is of the registry config
    kio = sum(count["components"].get(k, {}).get("bytes", 0.0)
              for k in KERNEL_IO)
    out = {
        "arch": arch,
        "cell": cell_name,
        "mesh": MESH,
        "variant": variant,
        "compile_s": rec["compile_s"],
        "bytes_per_device": None,
        "hlo_flops_per_device": rec["hlo_flops_per_device"],
        "hlo_bytes_per_device": rec["hlo_bytes_per_device"],
        "excluded_vmem_bytes": 0.0,
        "kernel_io_addback_bytes": kio,
        "collective_bytes_per_device": rec["collective_bytes_per_device"],
        "collectives": {},
        **{k: rec[k] for k in ("t_compute_s", "t_memory_s",
                               "t_collective_s")},
        "dominant": rec["dominant"],
        "useful_flops_ratio": rec["useful_flops_ratio"],
        "roofline_fraction": rec["roofline_fraction"],
        "accounting": "kernel interiors on chip: only the kernels' HBM "
                      "inputs and outputs count (flash_vmem is the "
                      "port's default)",
        "components": count["components"],
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="perf.jsonl")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the port counts one device; pod meshes are "
            "ROADMAP A10")
    rec = perf_record(args.arch, args.cell, args.variant)
    print(json.dumps(rec, indent=1))
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
