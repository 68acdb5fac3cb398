"""Public entry points of the kernels, as the models and engines call
them (counterpart of ``repro/kernels/ops.py``).

  * device dispatch — the hand-written CUDA kernel for a CUDA tensor,
    the plain PyTorch version for a CPU tensor;
  * no hardware padding: the kernels handle ragged shapes by bounds.
"""
from __future__ import annotations

from repro_torch.kernels import int8_quant as _q8

# --------------------------------------------------------------------------
# int8 boundary quantization
# --------------------------------------------------------------------------
int8_quantize = _q8.int8_quantize
int8_dequantize = _q8.int8_dequantize
