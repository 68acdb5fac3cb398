"""Configs of the port: the diffusion model of the split-serving path."""
from repro_torch.configs import stable_diffusion_v1

DIFFUSION_CONFIG = stable_diffusion_v1.CONFIG
