"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

24L, d_model=2560, 32H (GQA kv=8), d_ff=6912, vocab=32000, SWA window 4096.
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    activation="swiglu",
    attention_kind="swa",
    window=4096,
)
