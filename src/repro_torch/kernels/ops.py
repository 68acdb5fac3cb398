"""Public entry points of the kernels, as the models and engines call
them (counterpart of ``repro/kernels/ops.py``).

  * device dispatch — the hand-written CUDA kernel for a CUDA tensor,
    the plain PyTorch version for a CPU tensor;
  * no hardware padding: the kernels handle ragged shapes by bounds;
  * layout adaptation — models use (B, S, H, D); the attention kernel
    uses (B*H, S, D) with head minor.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_quant as _q8
from repro_torch.kernels import rglru_scan as _lru
from repro_torch.kernels import ssd_scan as _ssd


# --------------------------------------------------------------------------
# Flash attention (prefill): model layout (B, S, H, D)
# --------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal=True, window=0):
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, D).contiguous()
    o = _fa.flash_attention(qf, kf, vf, causal=causal, window=window,
                            softmax_scale=D ** -0.5)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2)


# --------------------------------------------------------------------------
# Decode attention: model layout q (B, 1, Hq, D), cache (B, Skv, Hkv, D)
# --------------------------------------------------------------------------
def decode_attention(q, k, v, lengths):
    """lengths (B,) int32 — valid KV length per sequence.  k and v are
    read in the cache's own layout, views included: no copy of the cache
    is made, and neither head_dim nor Skv is padded."""
    o = _dec.decode_attention(q[:, 0].contiguous(), k, v, lengths,
                              softmax_scale=q.shape[-1] ** -0.5)
    return o[:, None]


# --------------------------------------------------------------------------
# RG-LRU scan: (B, S, W) fp32 — drop-in for models.rglru.lru_scan_ref
# --------------------------------------------------------------------------
def rglru_scan(a, b, h0=None):
    return _lru.rglru_scan(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous())


# --------------------------------------------------------------------------
# SSD scan — drop-in for models.ssd.ssd_chunked_ref
# --------------------------------------------------------------------------
def ssd_scan(x, dt, A, Bm, Cm, *, chunk_size=128, init_state=None):
    return _ssd.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                         Bm.contiguous(), Cm.contiguous(),
                         chunk_size=chunk_size,
                         init_state=(None if init_state is None
                                     else init_state.contiguous()))


# --------------------------------------------------------------------------
# int8 boundary quantization
# --------------------------------------------------------------------------
int8_quantize = _q8.int8_quantize
int8_dequantize = _q8.int8_dequantize


def kernel_registry():
    """``kernel_fn`` entries for models.transformer, as the engines pass
    them: the dispatching wrappers, which the blocks also take when no
    entry is given."""
    return {"rglru": rglru_scan, "ssd": ssd_scan}
