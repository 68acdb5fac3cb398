"""Latent diffusion (Stable-Diffusion-v1-class) in PyTorch.

Three phases, exactly as the paper's codebase divides them (§5.1.2):
  encode   — CLIP-like text transformer -> context (2B, 77, 768)
             (2x = classifier-free guidance pair: uncond + cond)
  diffuse  — denoising U-Net over latents (B, 4, 64, 64), n_total iterations
  decode   — VAE decoder -> images (B, 3, 512, 512)

The paper's split points are after every ``split_stride`` denoising
iterations plus between the U-Net and the VAE ("denoising50").  The
boundary tensors are (latent fp32, context fp16) — ``split_payload``
reproduces paper Table 2's byte counts exactly.

``denoise_range(params, cfg, latent, ctx2, start_iter, stop_iter)`` is
the segmentation hook: the cloud runs iterations [0, n_cloud), ships the
payload, the device runs [n_cloud, n_total) + VAE decode.

Counterpart of ``repro/models/diffusion.py``: same public functions, same
parameter tree (same keys, same shapes, the ``None`` leaf at
``vae.stages[-1]["up"]`` included), weights and activations in fp32.
Tensors stay on the device their parameters are on.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.regnet import conv2d, init_conv

Params = Dict[str, Any]


# ==========================================================================
# Small helpers
# ==========================================================================
def init_ln(d, device: DeviceLike = None):
    device = resolve_device(device)
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def ln(p, x, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"],
                        eps).to(x.dtype)


def init_gn(c, device: DeviceLike = None):
    device = resolve_device(device)
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def gn(p, x, groups=32, eps=1e-5):
    """GroupNorm over NCHW; the largest group count <= ``groups`` that
    divides C (population variance, as ``F.group_norm`` has it)."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x.float(), g, p["scale"], p["bias"], eps).to(x.dtype)


def silu(x):
    return F.silu(x)


def gelu(x):
    """The tanh approximation — the default of the reference's gelu."""
    return F.gelu(x, approximate="tanh")


def upsample2x(x):
    """Nearest-neighbour resize of (B, C, H, W) to exactly twice the size."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _mha(q, k, v, heads, causal=False):
    """Plain matmul + fp32 softmax; the (Sq, Skv) scores are materialised."""
    B, Sq, D = q.shape
    hd = D // heads
    q = q.reshape(B, Sq, heads, hd)
    k = k.reshape(B, k.shape[1], heads, hd)
    v = v.reshape(B, v.shape[1], heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        msk = torch.tril(torch.ones((Sq, k.shape[1]), dtype=torch.bool,
                                    device=s.device))
        s = torch.where(msk, s, torch.full((), -1e30, dtype=s.dtype,
                                           device=s.device))
    p = torch.softmax(s.float(), -1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.reshape(B, Sq, D)


# ==========================================================================
# Text encoder (CLIP-ish)
# ==========================================================================
def init_text_encoder(cfg, generator, device: DeviceLike = None) -> Params:
    device = resolve_device(device)
    d = cfg.text_width
    f32 = torch.float32
    tok = embed_init(generator, (cfg.text_vocab, d), f32, device)
    pos = embed_init(generator, (cfg.text_len, d), f32, device)
    layers = []
    for _ in range(cfg.text_layers):
        layers.append({
            "ln1": init_ln(d, device),
            "wqkv": dense_init(generator, (d, 3 * d), f32, device=device),
            "wo": dense_init(generator, (d, d), f32, device=device),
            "ln2": init_ln(d, device),
            "w1": dense_init(generator, (d, 4 * d), f32, device=device),
            "w2": dense_init(generator, (4 * d, d), f32, device=device),
        })
    return {"tok": tok, "pos": pos, "layers": layers,
            "ln_f": init_ln(d, device)}


def encode_text(p, cfg, tokens):
    """tokens (B, 77) -> context (B, 77, width).  Causal, CLIP-style."""
    x = p["tok"][tokens] + p["pos"][None, : tokens.shape[1]]
    for lp in p["layers"]:
        h = ln(lp["ln1"], x)
        q, k, v = torch.chunk(torch.einsum("bsd,de->bse", h, lp["wqkv"]),
                              3, -1)
        x = x + torch.einsum("bsd,de->bse",
                             _mha(q, k, v, cfg.text_heads, causal=True),
                             lp["wo"])
        h = ln(lp["ln2"], x)
        x = x + torch.einsum("bsf,fd->bsd",
                             gelu(torch.einsum("bsd,df->bsf", h, lp["w1"])),
                             lp["w2"])
    return ln(p["ln_f"], x)


# ==========================================================================
# U-Net
# ==========================================================================
def _timestep_embedding(t, dim):
    """[cos, sin] in that order; ``t`` (B,) holds schedule indices."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init_resblock(generator, c_in, c_out, t_dim,
                  device: DeviceLike = None):
    device = resolve_device(device)
    p = {
        "gn1": init_gn(c_in, device),
        "conv1": init_conv(generator, c_in, c_out, 3, device=device),
        "t_proj": dense_init(generator, (t_dim, c_out), torch.float32,
                             device=device),
        "gn2": init_gn(c_out, device),
        "conv2": init_conv(generator, c_out, c_out, 3, device=device),
    }
    if c_in != c_out:
        p["skip"] = init_conv(generator, c_in, c_out, 1, device=device)
    return p


def apply_resblock(p, x, t_emb):
    h = conv2d(silu(gn(p["gn1"], x)), p["conv1"])
    h = h + torch.einsum("bt,tc->bc", silu(t_emb), p["t_proj"])[:, :, None, None]
    h = conv2d(silu(gn(p["gn2"], h)), p["conv2"])
    sc = conv2d(x, p["skip"]) if "skip" in p else x
    return h + sc


def init_xattn(generator, c, ctx_dim, heads, device: DeviceLike = None):
    device = resolve_device(device)
    f32 = torch.float32

    def dense(shape):
        return dense_init(generator, shape, f32, device=device)

    return {
        "gn": init_gn(c, device),
        "proj_in": init_conv(generator, c, c, 1, device=device),
        "ln1": init_ln(c, device), "wq1": dense((c, c)),
        "wkv1": dense((c, 2 * c)),
        "wo1": dense((c, c)),
        "ln2": init_ln(c, device), "wq2": dense((c, c)),
        "wkv2": dense((ctx_dim, 2 * c)),
        "wo2": dense((c, c)),
        "ln3": init_ln(c, device),
        "w1": dense((c, 4 * c)),
        "w2": dense((4 * c, c)),
        "proj_out": init_conv(generator, c, c, 1, device=device),
    }


def apply_xattn(p, x, ctx, heads):
    """Spatial transformer: self-attn + cross-attn(ctx) + MLP."""
    B, C, H, W = x.shape
    h = conv2d(gn(p["gn"], x), p["proj_in"])
    seq = h.reshape(B, C, H * W).transpose(1, 2)              # (B, HW, C)
    t = ln(p["ln1"], seq)
    k, v = torch.chunk(torch.einsum("bsc,ce->bse", t, p["wkv1"]), 2, -1)
    seq = seq + torch.einsum(
        "bsc,ce->bse",
        _mha(torch.einsum("bsc,ce->bse", t, p["wq1"]), k, v, heads), p["wo1"])
    t = ln(p["ln2"], seq)
    k, v = torch.chunk(torch.einsum("bsc,ce->bse", ctx, p["wkv2"]), 2, -1)
    seq = seq + torch.einsum(
        "bsc,ce->bse",
        _mha(torch.einsum("bsc,ce->bse", t, p["wq2"]), k, v, heads), p["wo2"])
    t = ln(p["ln3"], seq)
    seq = seq + torch.einsum(
        "bsf,fc->bsc", gelu(torch.einsum("bsc,cf->bsf", t, p["w1"])),
        p["w2"])
    h = seq.transpose(1, 2).reshape(B, C, H, W)
    return x + conv2d(h, p["proj_out"])


def init_unet(cfg, generator, device: DeviceLike = None) -> Params:
    device = resolve_device(device)
    base = cfg.unet_base
    t_dim = base * 4
    f32 = torch.float32
    p: Params = {
        "t_w1": dense_init(generator, (base, t_dim), f32, device=device),
        "t_w2": dense_init(generator, (t_dim, t_dim), f32, device=device),
        "conv_in": init_conv(generator, cfg.latent_channels, base, 3,
                             device=device),
    }
    chans = [base * m for m in cfg.unet_mults]
    downs = []
    skip_chans = [base]                     # mirrors the skips list in apply
    c_prev = base
    for lvl, c in enumerate(chans):
        blocks = []
        for _ in range(cfg.unet_res_blocks):
            blk = {"res": init_resblock(generator, c_prev, c, t_dim, device)}
            if lvl in cfg.unet_attn_levels:
                blk["attn"] = init_xattn(generator, c, cfg.text_width,
                                         cfg.unet_heads, device)
            blocks.append(blk)
            c_prev = c
            skip_chans.append(c)
        lvl_p = {"blocks": blocks}
        if lvl < len(chans) - 1:
            lvl_p["down"] = init_conv(generator, c, c, 3, device=device)
            skip_chans.append(c)
        downs.append(lvl_p)
    p["downs"] = downs
    p["mid1"] = init_resblock(generator, c_prev, c_prev, t_dim, device)
    p["mid_attn"] = init_xattn(generator, c_prev, cfg.text_width,
                               cfg.unet_heads, device)
    p["mid2"] = init_resblock(generator, c_prev, c_prev, t_dim, device)
    ups = []
    for lvl in reversed(range(len(chans))):
        c = chans[lvl]
        blocks = []
        for _ in range(cfg.unet_res_blocks + 1):
            c_skip = skip_chans.pop()
            blk = {"res": init_resblock(generator, c_prev + c_skip, c, t_dim,
                                        device)}
            if lvl in cfg.unet_attn_levels:
                blk["attn"] = init_xattn(generator, c, cfg.text_width,
                                         cfg.unet_heads, device)
            blocks.append(blk)
            c_prev = c
        lvl_p = {"blocks": blocks}
        if lvl > 0:
            lvl_p["up"] = init_conv(generator, c, c, 3, device=device)
        ups.append(lvl_p)
    p["ups"] = ups
    p["gn_out"] = init_gn(base, device)
    p["conv_out"] = init_conv(generator, base, cfg.latent_channels, 3,
                              device=device)
    return p


def apply_unet(p, cfg, latent, t, ctx):
    """latent (B,4,h,w), t (B,), ctx (B,77,width) -> predicted noise."""
    t_emb = _timestep_embedding(t, cfg.unet_base)
    t_emb = torch.einsum("bt,te->be", silu(torch.einsum(
        "bt,te->be", t_emb, p["t_w1"])), p["t_w2"])
    x = conv2d(latent, p["conv_in"])
    skips = [x]
    for lvl_p in p["downs"]:
        for blk in lvl_p["blocks"]:
            x = apply_resblock(blk["res"], x, t_emb)
            if "attn" in blk:
                x = apply_xattn(blk["attn"], x, ctx, cfg.unet_heads)
            skips.append(x)
        if "down" in lvl_p:
            x = conv2d(x, lvl_p["down"], stride=2)
            skips.append(x)
    x = apply_resblock(p["mid1"], x, t_emb)
    x = apply_xattn(p["mid_attn"], x, ctx, cfg.unet_heads)
    x = apply_resblock(p["mid2"], x, t_emb)
    for lvl_p in p["ups"]:
        for blk in lvl_p["blocks"]:
            x = torch.cat([x, skips.pop()], dim=1)
            x = apply_resblock(blk["res"], x, t_emb)
            if "attn" in blk:
                x = apply_xattn(blk["attn"], x, ctx, cfg.unet_heads)
        if "up" in lvl_p:
            x = conv2d(upsample2x(x), lvl_p["up"])
    return conv2d(silu(gn(p["gn_out"], x)), p["conv_out"])


# ==========================================================================
# VAE decoder
# ==========================================================================
def init_vae_decoder(cfg, generator, device: DeviceLike = None) -> Params:
    device = resolve_device(device)
    chans = [cfg.vae_base * m for m in reversed(cfg.vae_mults)]
    p: Params = {"conv_in": init_conv(generator, cfg.latent_channels,
                                      chans[0], 3, device=device)}
    stages = []
    c_prev = chans[0]
    for i, c in enumerate(chans):
        stages.append({
            "res1": init_resblock(generator, c_prev, c, 4, device),
            "res2": init_resblock(generator, c, c, 4, device),
            "up": (init_conv(generator, c, c, 3, device=device)
                   if i < len(chans) - 1 else None),
        })
        c_prev = c
    p["stages"] = stages
    p["gn_out"] = init_gn(c_prev, device)
    p["conv_out"] = init_conv(generator, c_prev, 3, 3, device=device)
    return p


def apply_vae_decoder(p, cfg, latent):
    t_emb = torch.zeros((latent.shape[0], 4), dtype=torch.float32,
                        device=latent.device)
    x = conv2d(latent / 0.18215, p["conv_in"])
    for st in p["stages"]:
        x = apply_resblock(st["res1"], x, t_emb)
        x = apply_resblock(st["res2"], x, t_emb)
        if st["up"] is not None:
            x = conv2d(upsample2x(x), st["up"])
    return torch.tanh(conv2d(silu(gn(p["gn_out"], x)), p["conv_out"]))


# ==========================================================================
# Full pipeline + segmentation hooks
# ==========================================================================
def init_params(cfg, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` and placed on ``device``
    (``None`` = the GPU; a missing GPU raises)."""
    dev = resolve_device(device)
    return {
        "text": init_text_encoder(cfg, generator, dev),
        "unet": init_unet(cfg, generator, dev),
        "vae": init_vae_decoder(cfg, generator, dev),
    }


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``linspace`` in fp32 by the reference's formula and rounding:
    ``start*(1-step) + stop*step`` with ``step = i * (1/(num-1))``, the
    end point appended.  The truncated schedule indices hang on these
    roundings: for 10 steps the fourth value is 665.99994 -> 665, where
    an exact computation gives 666."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    step = np.arange(num - 1, dtype=f32) * (f32(1.0) / f32(num - 1))
    out = f32(start) * (f32(1.0) - step) + f32(stop) * step
    return np.concatenate([out, np.array([stop], f32)]).astype(f32)


@functools.lru_cache(maxsize=None)
def _ddim_schedule(n_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side schedule, computed once per iteration count.

    The cumulative product is taken in float64 and rounded to fp32 once:
    the reference's fp32 scan lies within 1.3e-6 (relative) of that value,
    and a sequential fp32 product would lie further from it."""
    T = 1000
    betas = np.linspace(8.5e-4, 0.012, T)
    alphas_bar = np.cumprod(1.0 - betas).astype(np.float32)
    idx = _linspace_f32(T - 1, 0, n_total).astype(np.int32)
    alphas = alphas_bar[idx]
    alphas.setflags(write=False)
    idx.setflags(write=False)
    return alphas, idx


def ddim_alphas(cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Linear-beta DDPM schedule subsampled to n_total DDIM steps.

    Returns read-only numpy arrays (alphas_bar fp32, indices int32): the
    schedule is a handful of host scalars, not device data."""
    return _ddim_schedule(cfg.n_total_iterations)  # descending noise level


def encode_prompt(params, cfg, cond_tokens, uncond_tokens):
    """-> context (2, B, 77, width): the paper's '2x77x768' tensor."""
    cond = encode_text(params["text"], cfg, cond_tokens)
    uncond = encode_text(params["text"], cfg, uncond_tokens)
    return torch.stack([uncond, cond])


def denoise_step(params, cfg, latent, ctx2, step_idx: int):
    """One DDIM step with classifier-free guidance.  ctx2 (2,B,77,w);
    step_idx a Python int.

    The U-Net runs twice (uncond, then cond), not once on a doubled
    batch, as in the reference."""
    alphas, t_idx = ddim_alphas(cfg)
    a_t = alphas[step_idx]
    a_prev = (alphas[step_idx + 1]
              if step_idx + 1 < cfg.n_total_iterations else np.float32(1.0))
    one = np.float32(1.0)
    # the step's four coefficients, in fp32 on the host as the reference
    # computes them on its device
    c_eps_t, c_t = float(np.sqrt(one - a_t)), float(np.sqrt(a_t))
    c_prev, c_eps_prev = float(np.sqrt(a_prev)), float(np.sqrt(one - a_prev))
    t = torch.full((latent.shape[0],), int(t_idx[step_idx]),
                   dtype=torch.int32, device=latent.device)
    eps_u = apply_unet(params["unet"], cfg, latent, t, ctx2[0])
    eps_c = apply_unet(params["unet"], cfg, latent, t, ctx2[1])
    eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
    x0 = (latent - c_eps_t * eps) / c_t
    return c_prev * x0 + c_eps_prev * eps


def denoise_range(params, cfg, latent, ctx2, start_iter: int, stop_iter: int):
    """Run denoising iterations [start_iter, stop_iter).

    This is the paper's split: cloud runs [0, n_cloud), device runs
    [n_cloud, n_total).
    """
    for i in range(start_iter, stop_iter):
        latent = denoise_step(params, cfg, latent, ctx2, i)
    return latent


def generate(params, cfg, cond_tokens, uncond_tokens,
             generator: torch.Generator):
    """Full pipeline on one machine (the all-cloud / all-device baseline).
    The starting latent is drawn from ``generator`` on its device."""
    B = cond_tokens.shape[0]
    with torch.inference_mode():
        ctx2 = encode_prompt(params, cfg, cond_tokens, uncond_tokens)
        latent = torch.randn(
            (B, cfg.latent_channels, cfg.latent_size, cfg.latent_size),
            generator=generator, device=generator.device).to(ctx2.device)
        latent = denoise_range(params, cfg, latent, ctx2, 0,
                               cfg.n_total_iterations)
        return apply_vae_decoder(params["vae"], cfg, latent)


def split_payload(cfg, batch: int = 1) -> List[Tuple[str, int]]:
    """(split name, transfer bytes) for each split point — paper Table 2.

    latent fp32 + context fp16 for mid-diffusion splits; only the latent
    fp32 for 'denoising{n_total}' (context no longer needed).
    """
    latent_bytes = batch * cfg.latent_channels * cfg.latent_size ** 2 * 4
    ctx_bytes = 2 * batch * cfg.text_len * cfg.text_width * 2   # fp16
    out = [("denoising0", ctx_bytes)]
    for i in range(cfg.split_stride, cfg.n_total_iterations, cfg.split_stride):
        out.append((f"denoising{i}", latent_bytes + ctx_bytes))
    out.append((f"denoising{cfg.n_total_iterations}", latent_bytes))
    return out


# ==========================================================================
# nn.Module holder
# ==========================================================================
def _flatten(tree, prefix, out):
    """Replace every tensor leaf by its "/"-joined path; collect leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
                for i, v in enumerate(tree)]
    out[prefix] = tree
    return prefix


class DiffusionModel(torch.nn.Module):
    """Thin holder that registers the leaves of a parameter tree, so that
    ``.to(device)`` and ``state_dict()`` work.  The model code stays the
    plain functions above: ``model.params`` is the tree they take, rebuilt
    from the registered tensors (so it follows a ``.to``)."""

    def __init__(self, params: Params, cfg):
        super().__init__()
        self.cfg = cfg
        leaves: Dict[str, torch.Tensor] = {}
        self._skeleton = _flatten(params, "", leaves)
        for name, t in leaves.items():
            self.register_parameter(
                name, torch.nn.Parameter(t, requires_grad=False))

    def _rebuild(self, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: self._rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._rebuild(v) for v in node]
        return self._parameters[node].data

    @property
    def params(self) -> Params:
        return self._rebuild(self._skeleton)

    def forward(self, cond_tokens, uncond_tokens, generator):
        return generate(self.params, self.cfg, cond_tokens, uncond_tokens,
                        generator)
