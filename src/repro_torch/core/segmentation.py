"""Model segmentation: the paper's core mechanism, at both granularities.

* iteration granularity (diffusion): split after every ``split_stride``
  denoising iterations; payload = latent fp32 + context fp16 (Table 2).
* block/layer granularity (RegNet Table 1; generalized here to every LM
  architecture in the zoo): split at pattern-group boundaries; payload =
  hidden states (B, S, d_model) + any recurrent/conv boundary state.

``SplitPlan`` is what the scheduler hands to the serving engine: which
compiled segment executable to run, and what boundary payload to ship.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import SegmentCost


@dataclasses.dataclass(frozen=True)
class SplitPoint:
    name: str
    index: int                  # iteration count or layer-group index
    payload_bytes: int          # boundary transfer size (per request)
    cloud_flops: float          # work in [0, index)
    device_flops: float         # work in [index, end]


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    model: str
    granularity: str            # "iteration" | "layer"
    point: SplitPoint

    @property
    def cloud_fraction(self) -> float:
        tot = self.point.cloud_flops + self.point.device_flops
        return self.point.cloud_flops / tot if tot else 0.0


# --------------------------------------------------------------------------
# Iteration granularity (diffusion)
# --------------------------------------------------------------------------
def diffusion_split_points(cfg, unet_flops_per_iter: float,
                           decode_flops: float, batch: int = 1
                           ) -> List[SplitPoint]:
    from repro_torch.models.diffusion import split_payload
    payloads = dict(split_payload(cfg, batch))
    pts = []
    for name, nbytes in payloads.items():
        i = int(name.replace("denoising", ""))
        pts.append(SplitPoint(
            name=name, index=i, payload_bytes=nbytes,
            cloud_flops=i * unet_flops_per_iter * batch,
            device_flops=((cfg.n_total_iterations - i) * unet_flops_per_iter
                          + decode_flops) * batch))
    return pts


# --------------------------------------------------------------------------
# Layer granularity (LM architectures)
# --------------------------------------------------------------------------
def _group_param_bytes_split(cfg) -> Tuple[float, float, float]:
    """(embed+head params, params per pattern group, tail params)."""
    total = cfg.param_count()
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = total - emb
    n_units = cfg.num_groups() + (1 if cfg.tail_pattern() else 0)
    per_group = body / max(1, cfg.num_groups() + len(cfg.tail_pattern())
                           / max(1, len(cfg.block_pattern)))
    return emb, per_group, body


def boundary_state_bytes(cfg, batch: int, seq: int) -> int:
    """Extra state shipped across a layer split (besides hidden states).

    Full/SWA attention: nothing (the device recomputes its own layers'
    KV during its pass).  Recurrent/SSM archs in *streaming* mode would
    ship their O(1) state; for one-shot inference nothing extra is needed,
    so this returns the O(1) state size only for streaming use-cases.
    """
    extra = 0
    if cfg.ssm is not None:
        d, di = cfg.d_model, cfg.ssm.d_inner(cfg.d_model)
        H = cfg.ssm.n_heads(cfg.d_model)
        extra += batch * H * cfg.ssm.head_dim * cfg.ssm.d_state * 4
        extra += batch * (cfg.ssm.d_conv - 1) * (
            di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state) * 2
    if cfg.rglru is not None:
        w = cfg.rglru.lru_width or cfg.d_model
        extra += batch * w * 4
        extra += batch * (cfg.rglru.d_conv - 1) * w * 2
    return extra


def layer_split_points(cfg, batch: int, seq: int, *,
                       activation_bytes: int = 2,
                       streaming: bool = False) -> List[SplitPoint]:
    """Split points at pattern-group boundaries for an LM architecture.

    FLOPs model: 2 * params * tokens per segment (active params for MoE).
    Payload: hidden states (batch, seq, d_model) at ``activation_bytes``
    (bf16 on the wire by default; int8 with the §7 quantized transport).
    """
    G = cfg.num_groups()
    tokens = batch * seq
    active = cfg.active_param_count()
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body_active = active - emb
    per_group = body_active / (G + len(cfg.tail_pattern())
                               / max(1, len(cfg.block_pattern)))
    head_flops = 2.0 * cfg.vocab_size * cfg.d_model * tokens
    hidden_bytes = batch * seq * cfg.d_model * activation_bytes
    state_bytes = boundary_state_bytes(cfg, batch, seq) if streaming else 0
    pts = []
    total_body = 2.0 * body_active * tokens
    for g in range(G + 1):
        frac = g / G
        cloud = total_body * frac
        device = total_body * (1 - frac) + head_flops
        # g == 0 runs everything on the device: no boundary crossing, so
        # nothing is transferred; every real split ships the hidden
        # states (+ streaming state)
        payload = 0 if g == 0 else hidden_bytes + state_bytes
        pts.append(SplitPoint(
            name=f"group{g}", index=g, payload_bytes=payload,
            cloud_flops=cloud, device_flops=device))
    return pts


def to_segment_costs(points: Sequence[SplitPoint]) -> List[SegmentCost]:
    return [SegmentCost(split_index=p.index, cloud_flops=p.cloud_flops,
                        device_flops=p.device_flops,
                        payload_bytes=p.payload_bytes) for p in points]


# --------------------------------------------------------------------------
# Activation-size audit (paper Tables 1 & 2, for any model)
# --------------------------------------------------------------------------
def hidden_payload_bytes(cfg, batch: int, seq: int,
                         dtype_bytes: int = 2) -> int:
    return batch * seq * cfg.d_model * dtype_bytes


def executable_count(n_total: int, n_step: int) -> int:
    """How many distinct compiled cloud programs the step grid implies —
    the paper's 'server does not need to handle diverse requests' claim,
    made concrete for a JIT-compiled serving engine."""
    return n_total // n_step + 1
