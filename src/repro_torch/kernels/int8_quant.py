"""Per-row symmetric int8 quantisation of the split boundary.

``int8_quantize`` launches the hand-written CUDA kernel
(``csrc/int8_quant.cu``) for a CUDA tensor and uses the plain PyTorch
version ``int8_quantize_ref`` only for a tensor that lies on the CPU.
Counterpart of ``repro/kernels/int8_quant.py``.

  x (T, d) float -> q (T, d) int8, s (T, 1) fp32
  s = max(max|row| / 127, 1e-12),  q = clip(round_half_even(x / s), ±127)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches made by ``int8_quantize`` in this process (incremented
#: where the kernel is launched, and nowhere else)
launch_count = 0

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


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (q (T, d) int8, scales (T, 1) fp32).

    A CPU tensor goes to the plain version.  A CUDA tensor goes to the
    kernel, on the current stream and without synchronising, or this
    raises: it never falls back.
    """
    global launch_count
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"int8_quantize: unsupported device {x.device}")
        return int8_quantize_ref(x)
    if x.dim() != 2:
        raise ValueError(f"int8_quantize: expected (T, d), got {tuple(x.shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"int8_quantize: expected a float tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("int8_quantize: input must be contiguous")
    T, d = x.shape
    if d == 0:
        raise ValueError("int8_quantize: rows must not be empty")
    lib = _build.load_library()
    xf = x.to(torch.float32)
    q = torch.empty((T, d), dtype=torch.int8, device=x.device)
    s = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    if T == 0:
        return q, s
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_int8_quantize_rows(
            xf.data_ptr(), q.data_ptr(), s.data_ptr(), T, d, stream)
    _build.check_launch(lib, code, "int8_quantize")
    launch_count += 1
    return q, s


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scales
