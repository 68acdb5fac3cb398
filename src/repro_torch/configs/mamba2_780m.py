"""mamba2-780m — attention-free SSM (SSD / state-space duality).

48L, d_model=1536, vocab=50280, ssm_state=128, d_inner=2*d_model,
head_dim=64 (nheads=48).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
)
