"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Block:  x -> [gate branch: Linear -> GeLU] * [rec branch: Linear ->
causal depthwise conv1d -> RG-LRU] -> Linear out.

RG-LRU recurrence (per channel):
    r_t = sigmoid(blockdiag(W_a) u_t + b_a)          recurrence gate
    i_t = sigmoid(blockdiag(W_x) u_t + b_x)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Counterpart of ``repro/models/rglru.py``.  The scan over the sequence is
``kernel_fn`` when one is given, and ``kernels.ops.rglru_scan`` otherwise:
the hand-written CUDA kernel on a CUDA tensor, the associative scan
``lru_scan_ref`` on a CPU tensor.  The engines' ``kernel_registry()``
entry is that same wrapper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.models.common import dense_init, matmul_f32, pdtype

#: the reference's name for the plain scan (its oracle), which lives
#: beside the kernel's wrapper in the port
lru_scan_ref = rglru_scan_ref


def init_rglru_block(generator: torch.Generator, cfg,
                     device: DeviceLike = None):
    device = resolve_device(device)
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    nb = r.diag_blocks
    bs = w // nb
    dt = pdtype(cfg)
    p = {
        "w_rec_in": dense_init(generator, (d, w), dt, device=device),
        "w_gate_in": dense_init(generator, (d, w), dt, device=device),
        "conv_w": dense_init(generator, (r.d_conv, w), dt, fan_in=r.d_conv,
                             device=device),
        "wa": dense_init(generator, (nb, bs, bs), dt, fan_in=bs,
                         device=device),
        "wx": dense_init(generator, (nb, bs, bs), dt, fan_in=bs,
                         device=device),
    }
    # Lambda init so that a^(1/r) spans roughly [0.9, 0.999]
    lam_min, lam_max = 0.9, 0.999
    u = torch.rand((w,), generator=generator, device=generator.device)
    a_init = lam_min + u * (lam_max - lam_min)
    log_a = torch.log(a_init)                   # target log a at r=1
    lam = torch.log(torch.expm1(-log_a / r.c_constant))  # inverse softplus
    p.update({
        "ba": torch.zeros((w,), device=device),
        "bx": torch.zeros((w,), device=device),
        "lam": lam.to(device),
        "w_out": dense_init(generator, (w, d), dt, device=device),
    })
    return p


def _blockdiag(u, w):
    """u (..., nb*bs) @ blockdiag w (nb, bs, bs) -> (..., nb*bs)."""
    nb, bs, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, bs))
    yb = torch.einsum("...nb,nbc->...nc", ub, w)
    return yb.reshape(u.shape)


def _causal_depthwise_conv(x, conv_w, prefix=None):
    """x (B,S,W), conv_w (K,W); causal: y_t = sum_k w_k x_{t-K+1+k}.

    prefix: optional (B,K-1,W) left context (decode / split-boundary state).
    """
    K = conv_w.shape[0]
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prefix, x], dim=1)
    y = torch.zeros_like(x)
    S = x.shape[1]
    for k in range(K):
        y = y + conv_w[k] * xp[:, k:k + S]
    return y


def _lru_gates(p, u, c_constant):
    r_gate = torch.sigmoid(_blockdiag(u, p["wa"]).float() + p["ba"])
    i_gate = torch.sigmoid(_blockdiag(u, p["wx"]).float() + p["bx"])
    log_a = -c_constant * F.softplus(p["lam"]) * r_gate        # (B,S,W) fp32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (
        i_gate * u.float())
    return a, b


def apply_rglru_block(p, x, cfg, state=None, kernel_fn=None, *,
                      out_f32: bool = False):
    """x (B,S,d) -> (y (B,S,d), new_state).

    state: {"h": (B,W) fp32, "conv": (B,K-1,W)} carried across segments /
    decode steps (also the boundary state shipped by the paper's split).

    Under dense tensor parallelism ``p`` may hold one rank's channels: a
    block of ``W`` in the input products, the conv, ``ba``, ``bx`` and
    ``lam``, and the gate blocks ``wa``, ``wx`` that cover it.  All up to
    ``y`` is channel by channel, the state is the rank's, and the output
    is the rank's partial of ``w_out``, for the caller to sum; with
    ``out_f32`` it is left in fp32, unrounded (``common.matmul_f32``).
    """
    r = cfg.rglru
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate_in"]).float(),
                  approximate="tanh")
    u_pre = torch.einsum("bsd,dw->bsw", x, p["w_rec_in"])
    prefix = state["conv"] if state is not None else None
    u = _causal_depthwise_conv(u_pre, p["conv_w"], prefix)
    a, b = _lru_gates(p, u, r.c_constant)
    h0 = state["h"] if state is not None else None
    scan = kernel_fn if kernel_fn is not None else ops.rglru_scan
    h = scan(a, b, h0)                                         # (B,S,W) fp32
    y = (h * gate).to(x.dtype)
    out = (matmul_f32(y, p["w_out"]) if out_f32
           else torch.einsum("bsw,wd->bsd", y, p["w_out"]))
    K = p["conv_w"].shape[0]
    if prefix is None:
        prefix = u_pre.new_zeros((x.shape[0], K - 1, u_pre.shape[-1]))
    new_state = {
        "h": h[:, -1],
        # conv state carries the *pre-conv* inputs (the conv's left context)
        "conv": torch.cat([prefix, u_pre], dim=1)[:, -(K - 1):],
    }
    return out, new_state


def init_rglru_state(batch: int, cfg, device: DeviceLike = None):
    """Zero decode state on ``device`` (``None`` = the GPU)."""
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    device = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), device=device),
        "conv": torch.zeros((batch, r.d_conv - 1, w), dtype=pdtype(cfg),
                            device=device),
    }
