"""Three-term roofline from the compiled dry-run artifact.

    compute    = HLO_FLOPs  / (chips * 989e12  bf16 FLOP/s)      [H100]
    memory     = HLO_bytes  / (chips * 3.35e12 HBM B/s)
    collective = coll_bytes / (chips * 450e9   NVLink B/s per link)

HLO_FLOPs / HLO_bytes come from ``compiled.cost_analysis()`` (per-device
numbers for the SPMD-partitioned module).  collective_bytes is NOT in
cost_analysis: we parse the post-SPMD HLO text and sum operand sizes of
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per training step
(3 matmul passes), 2*N*D for inference steps; the ratio to HLO FLOPs
measures how much compiled compute is "useful" (catches remat/redundancy).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import numpy as np

PEAK_FLOPS = 989e12          # NVIDIA H100 dense bf16 per chip
HBM_BW = 3.35e12             # bytes/s per chip
ICI_BW = 450e9               # NVLink bytes/s per link


# --------------------------------------------------------------------------
# Accelerator architecture table: the roofline re-evaluated per hardware
# class, which is what calibrates per-class cloud rates (r_cloud) for
# core.capacity.CloudCapacity instead of hand calibration.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak numbers of one accelerator generation (dense bf16/fp16)."""
    name: str
    peak_flops: float        # FLOP/s per chip
    hbm_bw: float            # HBM bytes/s per chip
    ici_bw: float            # interconnect bytes/s per link

    def step_time_s(self, flops: float, bytes_: float,
                    coll_bytes: float = 0.0) -> float:
        """Roofline step latency: the binding term of one program step."""
        return max(flops / self.peak_flops, bytes_ / self.hbm_bw,
                   (coll_bytes / self.ici_bw) if coll_bytes else 0.0)


#: The hardware classes the calibration loop knows about.  h100 carries
#: the module-level constants (the card the port runs on); the other
#: entries model the generations a mixed production pool would hold.
HW_SPECS: Dict[str, HardwareSpec] = {
    "v5e": HardwareSpec("v5e", 197e12, 819e9, 50e9),
    "a100": HardwareSpec("a100", 312e12, 2.0e12, 300e9),
    "h100": HardwareSpec("h100", 989e12, 3.35e12, 450e9),
    "rtx4090": HardwareSpec("rtx4090", 165e12, 1.0e12, 16e9),
}


def r_cloud_estimates(flops_per_step: float, bytes_per_step: float,
                      coll_bytes_per_step: float = 0.0,
                      specs: Optional[Mapping[str, HardwareSpec]] = None
                      ) -> Dict[str, float]:
    """Per-architecture serving-rate estimates (steps/s per chip).

    One diffusion iteration (or decode step) costing ``flops_per_step`` /
    ``bytes_per_step`` per device runs at 1 / roofline-step-time on each
    hardware class — the ``r_cloud`` that ``CloudCapacity.from_roofline``
    consumes, replacing hand calibration of per-class rates.
    """
    out = {}
    for name, spec in (specs or HW_SPECS).items():
        t = spec.step_time_s(flops_per_step, bytes_per_step,
                             coll_bytes_per_step)
        out[name] = (1.0 / t) if t > 0 else float("inf")
    return out

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# shapes like f32[128,1024]{1,0} or bf16[2,4096]
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum output-shape bytes of every collective op in the HLO text.

    Uses the lhs (result) shape of each `<shape> <op-name> = ...` line,
    which for all-reduce equals the payload and for all-gather equals the
    gathered size (an upper bound on per-device wire bytes; consistent
    across iterations, which is what the §Perf deltas need).
    """
    out = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        s = line.strip()
        # result-name = shape op-name(...)
        m = re.match(r"%?[\w.\-]+ = ([^=]+?) (all-gather|all-reduce|"
                     r"reduce-scatter|all-to-all|collective-permute)", s)
        if m:
            out[m.group(2)] += _shape_bytes(m.group(1))
            continue
        # fusion-wrapped or start/done variants
        m2 = re.match(r"%?[\w.\-]+ = ([^=]+?) (all-gather-start|"
                      r"all-reduce-start|collective-permute-start)", s)
        if m2:
            op = m2.group(2).replace("-start", "")
            out[op] += _shape_bytes(m2.group(1))
    return out


def model_flops(cfg, cell) -> float:
    """6*N_active*D for train, 2*N_active*D per generated/processed token
    for inference cells."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * cell.global_batch


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float) -> Dict[str, float]:
    return {
        "t_compute_s": flops_per_device / PEAK_FLOPS,
        "t_memory_s": bytes_per_device / HBM_BW,
        "t_collective_s": coll_bytes_per_device / ICI_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(terms, key=lambda k: terms[k]).replace("t_", "").replace("_s", "")


def roofline_from_compiled(arch: str, cell_name: str, lowered, compiled,
                           n_chips: int) -> Dict:
    """Terms from the trip-count-corrected HLO analyzer.

    ``compiled.cost_analysis()`` visits while bodies once, so the raw
    numbers undercount scan-over-layers models by the layer count; the
    text analyzer (roofline.hlo_parser) folds loop trip counts back in.
    Raw numbers are kept under raw_* for comparison.
    """
    from repro_torch.configs import cell_by_name, get_config
    from repro_torch.roofline.hlo_parser import analyze, cost_analysis_dict
    cfg = get_config(arch)
    cell = cell_by_name(cell_name)
    cost = cost_analysis_dict(compiled)
    try:
        hlo = compiled.as_text()
    except Exception:
        hlo = lowered.as_text()
    corrected = analyze(hlo)
    flops = float(corrected["flops"])
    byts = float(corrected["bytes"])
    colls = corrected["collectives"]
    coll_total = float(corrected["collective_bytes"])
    terms = roofline_terms(flops, byts, coll_total)
    mf = model_flops(cfg, cell)
    mf_per_device = mf / n_chips
    dom = dominant_term(terms)
    denom = max(terms.values()) or 1e-30
    return {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": byts,
        "collective_bytes_per_device": coll_total,
        "collectives": {k: v for k, v in colls.items() if v},
        "raw_flops_per_device": float(cost.get("flops", 0.0)),
        "raw_bytes_per_device": float(cost.get("bytes accessed", 0.0)),
        **{k: round(v, 6) for k, v in terms.items()},
        "r_cloud_est": {k: round(v, 4) for k, v in
                        r_cloud_estimates(flops, byts, coll_total).items()},
        "dominant": dom,
        "model_flops_per_device": mf_per_device,
        "useful_flops_ratio": round(mf_per_device / flops, 4) if flops else None,
        "roofline_fraction": round(
            (mf_per_device / PEAK_FLOPS) / denom, 4) if denom else None,
    }
