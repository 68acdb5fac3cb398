"""seamless-m4t-medium — enc-dec multimodal (audio) backbone.

12L encoder + 12L decoder, d_model=1024, 16H (MHA, kv=16), d_ff=4096,
vocab=256206.  [arXiv:2308.11596; hf]  The speech frontend is a STUB:
``input_specs`` provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",
    norm="layernorm",
    attention_kind="full",
    frontend=FrontendConfig(kind="audio", num_positions=1024, embed_dim=1024),
)
