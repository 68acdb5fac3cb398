"""granite-moe-3b-a800m — MoE decoder LM.

32L, d_model=1536, 24H (GQA kv=8), per-expert d_ff=512, vocab=49155,
MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-*; hf]

40 experts is NOT divisible by the 16-way model axis, so the default MoE
partitioning is TP-within-expert (expert d_ff sharded over "model").
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512, partitioning="tp"),
)
