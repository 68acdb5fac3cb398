"""Mamba-2 block: SSD (state-space duality) with the chunked algorithm.

Block: in_proj -> [z | x | B | C | dt] -> causal depthwise conv over
[x, B, C] -> SSD -> + D * x skip -> gated RMSNorm(silu(z)) -> out_proj.

SSD recurrence per head (state S in R^{P x N}):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * (x_t outer B_t)
    y_t = S_t @ C_t + D * x_t

Counterpart of ``repro/models/ssd.py``.  The scan over the sequence is
``kernel_fn`` when one is given, and ``kernels.ops.ssd_scan`` otherwise:
the hand-written CUDA kernel on a CUDA tensor, the chunked plain version
``ssd_chunked_ref`` on a CPU tensor; under autograd either runs as
``kernels/ssd_scan.py::SSDScan``, the counterpart of its
``ssd_chunked_train``, whose backward is the vjp of the plain version.
The engines' ``kernel_registry()`` entry is that same wrapper.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.kernels import ops
# the reference's oracle keeps its name here; in the port it lives
# beside the kernel's wrapper
from repro_torch.kernels.ssd_scan import ssd_chunked_ref  # noqa: F401
from repro_torch.models.common import dense_init, matmul_f32, pdtype
from repro_torch.models.rglru import _causal_depthwise_conv


def dims(cfg):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    return d, di, H, s.head_dim, s.n_groups, s.d_state


def init_ssd_block(generator: torch.Generator, cfg, device: DeviceLike = None):
    """Separate projections per component (not mamba's fused in_proj), in
    the reference's tree."""
    device = resolve_device(device)
    s = cfg.ssm
    d, di, H, P, G, N = dims(cfg)
    dt = pdtype(cfg)

    def dense(shape, fan_in=None):
        return dense_init(generator, shape, dt, fan_in=fan_in, device=device)
    p = {
        "z_proj": dense((d, di)),
        "x_proj": dense((d, di)),
        "b_proj": dense((d, G * N)),
        "c_proj": dense((d, G * N)),
        "dt_proj": dense((d, H)),
        "conv_x": dense((s.d_conv, di), s.d_conv),
        "conv_b": dense((s.d_conv, G * N), s.d_conv),
        "conv_c": dense((s.d_conv, G * N), s.d_conv),
    }
    u = torch.rand((H,), generator=generator, device=generator.device)
    dt_init = torch.exp(math.log(s.dt_min)
                        + u * (math.log(s.dt_max) - math.log(s.dt_min)))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    p.update({
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt_bias.to(device),
        "D": torch.ones((H,), device=device),
        "norm_scale": torch.ones((di,), device=device),
        "out_proj": dense((di, d)),
    })
    return p


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrence.  x (b,h,p); dt (b,h); Bm, Cm (b,g,n) ->
    (y (b,h,p), state (b,h,p,n))."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=1)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    decay = torch.exp(dt * A)[..., None, None]                 # (b,h,1,1)
    state = decay * state + torch.einsum("bh,bhp,bhn->bhpn", dt, x, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


def apply_ssd_block(p, x_in, cfg, state=None, kernel_fn=None, *,
                    first_head: int = 0, norm_sum=None,
                    out_f32: bool = False):
    """x_in (B,S,d) -> (y (B,S,d), new_state).

    state: {"ssm": (B,H,P,N) fp32, "conv": (B,K-1,di+2GN)} — the conv
    state concatenates the [x | B | C] pre-conv context.

    Under dense tensor parallelism ``p`` may hold one rank's block:
    ``x_proj``, ``z_proj``, ``conv_x``, ``norm_scale`` and ``out_proj``
    cut by ``d_inner`` to whole heads, global heads ``[first_head,
    first_head + H_r)``, with ``b_proj``, ``c_proj``, ``dt_proj``,
    ``conv_b``, ``conv_c``, ``A_log``, ``dt_bias`` and ``D`` whole.  The
    scan then runs on those heads (their ``dt``, ``A``, ``D``), the state
    is the rank's (``ssm`` (B,H_r,P,N), ``conv`` [its x channels | B |
    C]), ``norm_sum`` sums the gated norm's (B,S,1) fp32 sums of squares
    over the ranks (its mean is over the whole ``d_inner``), and ``y`` is
    the rank's partial of ``out_proj``, for the caller to sum; with
    ``out_f32`` it is left in fp32, unrounded (``common.matmul_f32``).
    """
    s = cfg.ssm
    d, di, H, Pd, G, N = dims(cfg)
    B, S, _ = x_in.shape
    di_r = p["x_proj"].shape[-1]            # this rank's channels
    if di_r < di and norm_sum is None:
        raise ValueError(f"x_proj cut to {di_r} of {di} channels: the gated "
                         f"norm's mean is over all of them, pass norm_sum")
    heads = slice(first_head, first_head + di_r // Pd)
    zg = torch.einsum("bsd,de->bse", x_in, p["z_proj"])
    xs = torch.einsum("bsd,de->bse", x_in, p["x_proj"])
    Bs = torch.einsum("bsd,de->bse", x_in, p["b_proj"])
    Cs = torch.einsum("bsd,de->bse", x_in, p["c_proj"])
    dts = torch.einsum("bsd,de->bse", x_in, p["dt_proj"])[..., heads]
    if state is not None:
        px, pb, pc = torch.split(state["conv"], [di_r, G * N, G * N], dim=-1)
    else:
        px = pb = pc = None
    conv_state_in = torch.cat([xs, Bs, Cs], dim=-1)
    xs_c = F.silu(_causal_depthwise_conv(xs, p["conv_x"], px).float())
    Bs_c = F.silu(_causal_depthwise_conv(Bs, p["conv_b"], pb).float())
    Cs_c = F.silu(_causal_depthwise_conv(Cs, p["conv_c"], pc).float())
    xh = xs_c.reshape(B, S, di_r // Pd, Pd)
    Bm = Bs_c.reshape(B, S, G, N)
    Cm = Cs_c.reshape(B, S, G, N)
    dt = F.softplus(dts.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    s0 = state["ssm"] if state is not None else None
    fn = kernel_fn if kernel_fn is not None else ops.ssd_scan
    y, final = fn(xh, dt, A, Bm, Cm, chunk_size=s.chunk_size, init_state=s0)
    y = y + p["D"][heads][:, None] * xh
    y = y.reshape(B, S, di_r)
    # gated RMSNorm
    gated = y * F.silu(zg.float())
    if di_r < di:
        ms = norm_sum(gated.square().sum(dim=-1, keepdim=True)) / di
    else:
        ms = gated.square().mean(dim=-1, keepdim=True)
    y = (gated * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(x_in.dtype)
    out = (matmul_f32(y, p["out_proj"]) if out_f32
           else torch.einsum("bse,ed->bsd", y, p["out_proj"]))
    K = p["conv_x"].shape[0]
    prefix = (state["conv"] if state is not None else
              conv_state_in.new_zeros((B, K - 1, di_r + 2 * G * N)))
    new_state = {
        "ssm": final,
        "conv": torch.cat([prefix, conv_state_in], dim=1)[:, -(K - 1):],
    }
    return out, new_state


def init_ssd_state(batch: int, cfg, device: DeviceLike = None):
    """Zero decode state on ``device`` (``None`` = the GPU)."""
    s = cfg.ssm
    d, di, H, Pd, G, N = dims(cfg)
    device = resolve_device(device)
    return {
        "ssm": torch.zeros((batch, H, Pd, N), device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * G * N),
                            dtype=pdtype(cfg), device=device),
    }
