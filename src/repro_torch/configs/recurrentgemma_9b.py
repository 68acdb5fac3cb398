"""recurrentgemma-9b — hybrid RG-LRU + local attention, pattern 1 attn : 2 rec.

38L, d_model=4096, 16H (MQA kv=1), d_ff=12288, vocab=256000, window=2048.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    activation="gelu",
    attention_kind="swa",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    rglru=RGLRUConfig(lru_width=4096),
)
