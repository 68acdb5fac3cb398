"""olmoe-1b-7b — MoE decoder LM.

16L, d_model=2048, 16H (GQA kv=16), per-expert d_ff=1024, vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]

64 experts divides the 16-way model axis -> expert-parallel partitioning.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    activation="swiglu",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, partitioning="ep"),
)
