"""Per-row symmetric int8 quantisation of the split boundary.

``int8_quantize_group`` quantises a group of row segments in one launch
of the hand-written CUDA kernel (``csrc/int8_quant.cu``) into one output
buffer, so that one copy brings every code and scale to the host;
``int8_quantize`` is its one-segment call.  Both take the kernel for a
CUDA tensor and the plain PyTorch version (``int8_quantize_ref``,
``int8_quantize_group_ref``) only for a tensor that lies on the CPU.
Counterpart of ``repro/kernels/int8_quant.py``.

  x (T, d) float -> q (T, d) int8, s (T, 1) fp32
  s = max(max|row| / 127, 1e-12),  q = clip(round_half_even(x / s), ±127)
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

#: kernel launches made by ``int8_quantize_group`` (and so by
#: ``int8_quantize``) in this process: one a launch, counted where the
#: kernel is launched and nowhere else
launch_count = 0

#: row segments one launch takes (the C entry's table)
MAX_SEGMENTS = 8

_FLOAT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def int8_quantize_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same arithmetic on any device.

    Both divides are by tensors: PyTorch turns a division by a Python
    scalar on a CUDA tensor into a multiply by the reciprocal, which is
    not the IEEE quotient the reference computes.  ``torch.round`` rounds
    half to even, as ``jnp.round`` and ``np.round`` do.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1, keepdim=True)
    s = (amax / amax.new_full((), 127.0)).clamp_min(1e-12)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s


def group_layout(shapes: Sequence[Tuple[int, int]]
                 ) -> Tuple[List[int], List[int], int]:
    """Byte offsets in a group's one output buffer, for segments of
    ``shapes`` (T_k, d_k): every segment's scales first ((T_k,) fp32 each,
    back to back), then every segment's codes (T_k * d_k int8, row-major),
    each starting on a 16-byte boundary.  Returns (scale offsets, code
    offsets, buffer bytes); the bytes between segments are undefined."""
    s_offs, off = [], 0
    for T, _ in shapes:
        s_offs.append(off)
        off += 4 * T
    q_offs = []
    for T, d in shapes:
        off = -(-off // 16) * 16
        q_offs.append(off)
        off += T * d
    return s_offs, q_offs, off


def split_group(buf, shapes: Sequence[Tuple[int, int]]) -> list:
    """[(q (T, d) int8, s (T, 1) fp32)] for each segment: views into
    ``buf``, a group's uint8 buffer as a tensor or a numpy array."""
    i8, f32 = ((np.int8, np.float32) if isinstance(buf, np.ndarray)
               else (torch.int8, torch.float32))
    s_offs, q_offs, _ = group_layout(shapes)
    return [(buf[qo:qo + T * d].view(i8).reshape(T, d),
             buf[so:so + 4 * T].view(f32).reshape(T, 1))
            for (T, d), so, qo in zip(shapes, s_offs, q_offs)]


def int8_quantize_group_ref(segments: Sequence[torch.Tensor]
                            ) -> torch.Tensor:
    """Plain version of the grouped kernel: ``int8_quantize_ref`` on each
    segment, written into one buffer laid out by ``group_layout``."""
    shapes = [tuple(x.shape) for x in segments]
    out = torch.zeros(group_layout(shapes)[2], dtype=torch.uint8,
                      device=segments[0].device)
    for x, (q_dst, s_dst) in zip(segments, split_group(out, shapes)):
        q, s = int8_quantize_ref(x)
        q_dst.copy_(q)
        s_dst.copy_(s)
    return out


def _check(x, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (T, d), got {tuple(x.shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{what}: expected a float tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.shape[1] == 0:
        raise ValueError(f"{what}: rows must not be empty")


def int8_quantize_group(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row segments, each (T_k, d_k) float, all on one device -> one uint8
    buffer with every segment's codes and scales (``group_layout``; read
    it with ``split_group``).

    A CPU group goes to the plain version.  A CUDA group goes to one
    launch of the kernel, on the current stream and without
    synchronising, or this raises: it never falls back."""
    global launch_count
    segments = list(segments)
    if not segments:
        raise ValueError("int8_quantize_group: no segments")
    dev = segments[0].device
    if any(x.device != dev for x in segments):
        raise ValueError("int8_quantize_group: segments on several devices")
    if dev.type == "cpu":
        return int8_quantize_group_ref(segments)
    if dev.type != "cuda":
        raise ValueError(f"int8_quantize_group: unsupported device {dev}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"int8_quantize_group: {len(segments)} segments, "
                         f"at most {MAX_SEGMENTS} a launch")
    for x in segments:
        _check(x, "int8_quantize_group")
    lib = _build.load_library()
    shapes = [tuple(x.shape) for x in segments]
    s_offs, q_offs, nbytes = group_layout(shapes)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    live = [k for k, (T, _) in enumerate(shapes) if T > 0]
    if not live:
        return out
    xs = [segments[k].to(torch.float32) for k in live]
    n = len(live)
    with torch.cuda.device(dev):
        code = lib.repro_int8_quantize_group(
            (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs)),
            (ctypes.c_longlong * n)(*(shapes[k][0] for k in live)),
            (ctypes.c_longlong * n)(*(shapes[k][1] for k in live)),
            (ctypes.c_longlong * n)(*(q_offs[k] for k in live)),
            (ctypes.c_longlong * n)(*(s_offs[k] for k in live)),
            n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, code, "int8_quantize_group")
    launch_count += 1
    return out


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (q (T, d) int8, scales (T, 1) fp32).

    A CPU tensor goes to the plain version.  A CUDA tensor goes to the
    kernel as a group of one segment, on the current stream and without
    synchronising, or this raises: it never falls back.
    """
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"int8_quantize: unsupported device {x.device}")
        return int8_quantize_ref(x)
    return split_group(int8_quantize_group([x]), [tuple(x.shape)])[0]


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scales
