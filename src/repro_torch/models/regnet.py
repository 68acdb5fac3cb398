"""RegNet-Y in PyTorch (NCHW) — the paper's image-classification model.

Counterpart of ``repro/models/regnet.py``: stem 3x3/2, four stages of
Y-bottleneck blocks (1x1 -> grouped 3x3 -> SE -> 1x1, residual), head
avgpool + fc.  BatchNorm runs in inference mode (folded running stats).
The convolutions are ``F.conv2d`` (cuDNN on the card, fp32 with TF32 off)
with the reference's "SAME" padding; the diffusion model shares
``conv2d`` and ``init_conv``.

Split points (paper Table 1): stem, block1..block4, avgpool.  Each returns
the activation the cloud would ship to the device at that point;
``split_activations`` computes their exact byte sizes on the ``meta``
device, the counterpart of ``jax.eval_shape``: nothing is allocated.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.common import dense_init

SPLIT_POINTS = ("stem", "block1", "block2", "block3", "block4", "avgpool")


# --------------------------------------------------------------------------
# Primitives (NCHW)
# --------------------------------------------------------------------------
def _same_pad(n: int, k: int, stride: int):
    """(low, high) padding of XLA's "SAME": the output has ceil(n/stride)
    positions and an odd total puts the extra element on the high side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride=1, groups=1):
    """x (B, C, H, W), w OIHW, "SAME" padding as the reference has it —
    with stride 2 on an even input that is low 0 / high 1, which a
    symmetric ``padding=1`` would get wrong."""
    top, bottom = _same_pad(x.shape[2], w.shape[2], stride)
    left, right = _same_pad(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left),
                        groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride, padding=0, groups=groups)


def init_conv(generator, c_in, c_out, k, groups=1,
              device: DeviceLike = None):
    device = resolve_device(device)
    fan = c_in // groups * k * k
    return dense_init(generator, (c_out, c_in // groups, k, k),
                      torch.float32, fan_in=fan, device=device)


def init_bn(c, device: DeviceLike = None):
    device = resolve_device(device)
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def bn(p, x):
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def relu(x):
    return torch.relu(x)


# --------------------------------------------------------------------------
# Y block
# --------------------------------------------------------------------------
def init_yblock(generator, c_in, c_out, stride, group_width, se_ratio,
                device: DeviceLike = None):
    dev = resolve_device(device)
    groups = max(1, c_out // group_width)
    c_se = max(1, int(c_in * se_ratio))
    p = {
        "conv1": init_conv(generator, c_in, c_out, 1, device=dev),
        "bn1": init_bn(c_out, dev),
        "conv2": init_conv(generator, c_out, c_out, 3, groups, device=dev),
        "bn2": init_bn(c_out, dev),
        "se_fc1": init_conv(generator, c_out, c_se, 1, device=dev),
        "se_fc2": init_conv(generator, c_se, c_out, 1, device=dev),
        "conv3": init_conv(generator, c_out, c_out, 1, device=dev),
        "bn3": init_bn(c_out, dev),
    }
    if stride != 1 or c_in != c_out:
        p["proj"] = init_conv(generator, c_in, c_out, 1, device=dev)
        p["proj_bn"] = init_bn(c_out, dev)
    return p


def apply_yblock(p, x, s: int, g: int):
    h = relu(bn(p["bn1"], conv2d(x, p["conv1"])))
    h = relu(bn(p["bn2"], conv2d(h, p["conv2"], stride=s, groups=g)))
    # squeeze-and-excite
    z = h.mean(dim=(2, 3), keepdim=True)
    z = relu(conv2d(z, p["se_fc1"]))
    z = torch.sigmoid(conv2d(z, p["se_fc2"]))
    h = h * z
    h = bn(p["bn3"], conv2d(h, p["conv3"]))
    sc = x
    if "proj" in p:
        sc = bn(p["proj_bn"], conv2d(x, p["proj"], stride=s))
    return relu(h + sc)


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------
def init_params(cfg, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` and placed on ``device``
    (``None`` = the GPU; a missing GPU raises; ``"meta"`` draws nothing).
    The nesting is the reference's: ``stage{i}`` is a list of block dicts."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        "stem_conv": init_conv(generator, 3, cfg.stem_width, 3, device=dev),
        "stem_bn": init_bn(cfg.stem_width, dev),
    }
    c_in = cfg.stem_width
    for i, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
        blocks = []
        for j in range(d):
            blocks.append(init_yblock(
                generator, c_in if j == 0 else w, w, 2 if j == 0 else 1,
                cfg.group_width, cfg.se_ratio, dev))
            c_in = w
        params[f"stage{i + 1}"] = blocks
    params["fc"] = dense_init(generator, (cfg.widths[-1], cfg.num_classes),
                              torch.float32, device=dev)
    params["fc_bias"] = torch.zeros((cfg.num_classes,), device=dev)
    return params


def run_from(params, cfg, x, start: str = "input", stop: str = "logits"):
    """Run from split point `start` (x = activation there) to `stop`.

    This IS the paper's RegNet segmentation: the cloud runs
    run_from(input -> p), ships the activation, the device runs
    run_from(p -> logits).
    """
    order = ("input",) + SPLIT_POINTS + ("logits",)
    assert start in order and stop in order
    si, ei = order.index(start), order.index(stop)

    def seg_stem(x):
        return relu(bn(params["stem_bn"],
                       conv2d(x, params["stem_conv"], stride=2)))

    def make_stage(i):
        w = cfg.widths[i - 1]
        groups = max(1, w // cfg.group_width)

        def f(x):
            for j, bp in enumerate(params[f"stage{i}"]):
                x = apply_yblock(bp, x, 2 if j == 0 else 1, groups)
            return x
        return f

    segments = {
        "stem": seg_stem,
        "block1": make_stage(1), "block2": make_stage(2),
        "block3": make_stage(3), "block4": make_stage(4),
        "avgpool": lambda x: x.mean(dim=(2, 3), keepdim=True),
        "logits": lambda x: x[:, :, 0, 0] @ params["fc"] + params["fc_bias"],
    }
    for name in order[si + 1: ei + 1]:
        x = segments[name](x)
    return x


def forward(params, cfg, images):
    """images (B, 3, H, W) -> logits (B, num_classes)."""
    return run_from(params, cfg, images, "input", "logits")


def split_activations(cfg) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(split point, activation shape, bytes) for batch 1 — paper Table 1.
    Parameters and activations live on the ``meta`` device: shapes and
    types only, so the full width allocates nothing."""
    meta = torch.device("meta")
    params = init_params(cfg, torch.Generator(), meta)
    act = torch.empty((1, 3, cfg.image_size, cfg.image_size),
                      dtype=torch.float32, device=meta)
    out = []
    prev = "input"
    for name in SPLIT_POINTS:
        act = run_from(params, cfg, act, prev, name)
        out.append((name, tuple(act.shape),
                    act.numel() * act.element_size()))
        prev = name
    return out
