"""Dense FFN variants: SwiGLU (llama-family), GELU, squared-ReLU (nemotron).

Counterpart of ``repro/models/mlp.py``.  ``jax.nn.gelu`` defaults to the
tanh approximation, so this one uses ``approximate="tanh"`` too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.common import dense_init, matmul_f32, pdtype


def init_mlp(generator: torch.Generator, cfg, d: int | None = None,
             f: int | None = None, device: DeviceLike = None):
    device = resolve_device(device)
    d = d or cfg.d_model
    f = f or cfg.d_ff
    dt = pdtype(cfg)
    if cfg.activation == "swiglu":
        return {
            "wi_gate": dense_init(generator, (d, f), dt, device=device),
            "wi_up": dense_init(generator, (d, f), dt, device=device),
            "wo": dense_init(generator, (f, d), dt, device=device),
        }
    return {"wi": dense_init(generator, (d, f), dt, device=device),
            "wo": dense_init(generator, (f, d), dt, device=device)}


def apply_mlp(p, x, cfg, *, out_f32: bool = False):
    """The FFN of ``x``; with ``out_f32`` its output product in fp32,
    unrounded (``common.matmul_f32``): a rank's partial over its ``d_ff``
    columns, for a sum over the model axis that rounds once."""
    if cfg.activation == "swiglu":
        g = torch.einsum("...d,df->...f", x, p["wi_gate"])
        u = torch.einsum("...d,df->...f", x, p["wi_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.einsum("...d,df->...f", x, p["wi"])
        if cfg.activation == "relu2":
            h = F.relu(h.float()).square().to(x.dtype)
        else:  # gelu
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    if out_f32:
        return matmul_f32(h, p["wo"])
    return torch.einsum("...f,fd->...d", h, p["wo"])
