"""nemotron-4-15b — dense decoder LM with squared-ReLU MLP.

32L, d_model=6144, 48H (GQA kv=8), d_ff=24576, vocab=256000.
[arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
)
