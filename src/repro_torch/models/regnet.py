"""Convolution primitives (NCHW) shared with the diffusion model.

Counterpart of the primitives of ``repro/models/regnet.py``; the RegNet
model itself is not part of the port yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.common import dense_init


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
