"""Shared neural-net primitives: initializers.

Models of the port are plain functions ``f(params, cfg, x)`` over nested
dicts of ``torch.Tensor``.  Where the reference takes a PRNG key, the
port takes an explicit ``torch.Generator``; numbers are drawn on the
generator's device and moved to ``device``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, fan_in: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal scaled by 1/sqrt(fan_in) (fan_in = shape[0] default)."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), dtype=torch.float32,
                    device=generator.device, generator=generator)
    return (w * 0.02).to(device=device, dtype=dtype)
