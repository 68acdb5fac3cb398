"""stable-diffusion-v1-class latent diffusion — the paper's generative model.

CLIP-like text encoder -> (2, 77, 768) context; denoising U-Net over
(4, 64, 64) latents for n_total=50 iterations; VAE decoder -> 512x512 RGB.
Split points after every 5 denoising iterations + before the VAE decode
(paper Table 2: context fp16 = 232 KB, latent fp32 = 64 KB, both = 296 KB).
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    name: str = "stable-diffusion-v1"
    # latent space
    latent_channels: int = 4
    latent_size: int = 64
    image_size: int = 512
    # text encoder (CLIP-ish)
    text_len: int = 77
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_vocab: int = 49408
    # U-Net
    unet_base: int = 320
    unet_mults: Tuple[int, ...] = (1, 2, 4, 4)
    unet_attn_levels: Tuple[int, ...] = (0, 1, 2)   # levels with cross-attn
    unet_res_blocks: int = 2
    unet_heads: int = 8
    # sampler
    n_total_iterations: int = 50
    split_stride: int = 5           # paper: split points every 5 iterations
    # VAE decoder
    vae_base: int = 128
    vae_mults: Tuple[int, ...] = (1, 2, 4, 4)
    guidance_scale: float = 7.5


CONFIG = DiffusionConfig()


def reduced() -> DiffusionConfig:
    """Tiny same-family config for CPU smoke tests."""
    return DiffusionConfig(
        name="stable-diffusion-smoke",
        latent_channels=4,
        latent_size=8,
        image_size=32,
        text_len=16,
        text_width=64,
        text_layers=2,
        text_heads=4,
        text_vocab=256,
        unet_base=32,
        unet_mults=(1, 2),
        unet_attn_levels=(0, 1),
        unet_res_blocks=1,
        unet_heads=4,
        n_total_iterations=10,
        split_stride=2,
        vae_base=16,
        vae_mults=(1, 2),
    )
