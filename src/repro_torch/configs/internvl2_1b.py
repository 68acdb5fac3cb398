"""internvl2-1b — VLM: InternViT frontend (STUB) + Qwen2-0.5B-class LM backbone.

24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151655.
[arXiv:2404.16821; hf]  The vision tower is a STUB: ``input_specs`` provides
precomputed patch embeddings prepended to the text sequence.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    activation="swiglu",
    qkv_bias=True,
    frontend=FrontendConfig(kind="vision", num_positions=256, embed_dim=896),
)
