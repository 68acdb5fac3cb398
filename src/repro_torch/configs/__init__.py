"""Architecture registry: ``get_config(arch_id)`` + reduced smoke variants."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SHAPE_CELLS,
    ShapeCell,
    SSMConfig,
    cell_by_name,
)

from repro_torch.configs import (  # noqa: E402  (registry imports)
    granite_moe_3b_a800m,
    h2o_danube_1_8b,
    internvl2_1b,
    mamba2_780m,
    nemotron_4_15b,
    olmoe_1b_7b,
    qwen2_7b,
    recurrentgemma_9b,
    seamless_m4t_medium,
    smollm_135m,
)
from repro_torch.configs import regnet_y_128gf, stable_diffusion_v1

_LM_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        seamless_m4t_medium.CONFIG,
        granite_moe_3b_a800m.CONFIG,
        olmoe_1b_7b.CONFIG,
        recurrentgemma_9b.CONFIG,
        nemotron_4_15b.CONFIG,
        smollm_135m.CONFIG,
        h2o_danube_1_8b.CONFIG,
        qwen2_7b.CONFIG,
        internvl2_1b.CONFIG,
        mamba2_780m.CONFIG,
    )
}

REGNET_CONFIG = regnet_y_128gf.CONFIG
DIFFUSION_CONFIG = stable_diffusion_v1.CONFIG

ARCH_IDS: List[str] = list(_LM_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _LM_REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_LM_REGISTRY)}"
        )
    return _LM_REGISTRY[arch]


def reduced_config(arch: str) -> ModelConfig:
    """A tiny same-family variant of `arch` for CPU smoke tests.

    Shrinks depth/width/experts/vocab but preserves every structural feature
    (GQA ratio, MoE routing, block pattern, attention kind, biases, frontend).
    """
    c = get_config(arch)
    ratio = max(1, c.num_heads // max(1, c.num_kv_heads))
    heads = 4 if c.num_heads else 0
    kv = max(1, heads // min(ratio, heads)) if heads else 0
    moe = None
    if c.moe is not None:
        moe = dataclasses.replace(
            c.moe, num_experts=8, top_k=min(2, c.moe.top_k), d_ff=64
        )
    ssm = None
    if c.ssm is not None:
        ssm = dataclasses.replace(
            c.ssm, d_state=16, head_dim=16, chunk_size=32
        )
    rglru = None
    if c.rglru is not None:
        rglru = dataclasses.replace(c.rglru, lru_width=64)
    frontend = None
    if c.frontend is not None:
        frontend = dataclasses.replace(
            c.frontend, num_positions=8, embed_dim=64
        )
    n_layers = max(2, 2 * len(c.block_pattern))
    if c.block_pattern != ("attn",) and len(c.block_pattern) > 1:
        n_layers = len(c.block_pattern) + 2  # exercise tail-pattern handling
    return dataclasses.replace(
        c,
        name=c.name + "-smoke",
        num_layers=n_layers,
        encoder_layers=2 if c.encoder_layers else 0,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=128 if c.d_ff else 0,
        vocab_size=512,
        window=min(c.window, 32) if c.window else 0,
        moe=moe,
        ssm=ssm,
        rglru=rglru,
        frontend=frontend,
        max_seq_len=4096,
    )


__all__ = [
    "ARCH_IDS",
    "DIFFUSION_CONFIG",
    "FrontendConfig",
    "ModelConfig",
    "MoEConfig",
    "REGNET_CONFIG",
    "RGLRUConfig",
    "SHAPE_CELLS",
    "SSMConfig",
    "ShapeCell",
    "cell_by_name",
    "get_config",
    "reduced_config",
]
