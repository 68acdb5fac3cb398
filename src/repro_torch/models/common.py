"""Shared neural-net primitives: norms, RoPE, initializers, dtype policy.

Models of the port are plain functions ``f(params, cfg, x)`` over nested
dicts of ``torch.Tensor``.  Where the reference takes a PRNG key, the
port takes an explicit ``torch.Generator``; numbers are drawn on the
generator's device and moved to ``device`` (``None`` = the GPU).  Compute
dtype is the parameters' (bfloat16 for the LM zoo) with fp32 islands for
norms, softmax and gates, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.compat import DeviceLike, resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def pdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, fan_in: Optional[int] = None,
               device: DeviceLike = None) -> torch.Tensor:
    """Truncated-normal scaled by 1/sqrt(fan_in) (fan_in = shape[0] default).
    On the ``meta`` device nothing is drawn: the tensor has its shape and
    type only (``regnet.split_activations``)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(device=dev, dtype=dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype,
               device: DeviceLike = None) -> torch.Tensor:
    w = torch.randn(tuple(shape), dtype=torch.float32,
                    device=generator.device, generator=generator)
    return (w * 0.02).to(device=resolve_device(device), dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_norm(cfg, d: int, device: DeviceLike = None):
    device = resolve_device(device)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(p, x, eps: float = 1e-6):
    """RMSNorm (or LayerNorm when ``p`` has a bias) in fp32; the result
    is cast back to ``x``'s dtype."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: DeviceLike = None) -> torch.Tensor:
    device = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Half-split rotation: the first half of ``head_dim``
    pairs with the second."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs   # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
