"""Prefill flash attention in the kernel layout.

``flash_attention`` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors and uses the plain PyTorch
version ``flash_attention_ref`` only for tensors that lie on the CPU.
Counterpart of ``repro/kernels/flash_attention.py``; the plain version
mirrors ``repro/kernels/ref.py::flash_attention_ref``.

  q (B*Hq, Sq, d), k and v (B*Hkv, Skv, d), head minor in the leading
  dimension, so q row ``bh`` reads kv row ``bh // (Hq / Hkv)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches made by ``flash_attention`` in this process
#: (incremented where the kernel is launched, and nowhere else)
launch_count = 0

#: the dtypes the kernel takes, with their code in the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len: Optional[int] = None, softmax_scale=None):
    """Plain PyTorch version, same layout: the whole score matrix in fp32,
    masked to -1e30, one softmax, output in q's dtype."""
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    group = BHq // BHkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(BHkv, group, Sq, d).float()
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None, None], s, torch.full((), NEG_INF,
                                                    device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.reshape(BHq, Sq, d).to(q.dtype)


def _check(q, k, v, kv_len: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: expected q (BHq,Sq,d), k and v "
                         f"(BHkv,Skv,d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[2] != k.shape[2]:
        raise ValueError("flash_attention: k and v must have one shape and "
                         "q the same head_dim")
    if q.shape[0] % k.shape[0] != 0:
        raise ValueError("flash_attention: B*Hq must be a multiple of B*Hkv")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[2]
    if d % 4 != 0 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    if not 0 < kv_len <= k.shape[1]:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"(0, {k.shape[1]}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, softmax_scale=None):
    """q (BHq, Sq, d); k, v (BHkv, Skv, d) -> o (BHq, Sq, d) in q's dtype.

    CPU tensors go to the plain version.  CUDA tensors go to the kernel,
    on the current stream and without synchronising, or this raises: it
    never falls back.  On CUDA tensors it also raises when autograd would
    follow an input: the kernel has no backward yet (ROADMAP A9).
    """
    global launch_count
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len, softmax_scale=softmax_scale)
    _build.refuse_grad("flash_attention", q, k, v)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    lib = _build.load_library()
    o = torch.empty_like(q)
    if Sq == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BHq, BHkv, Sq, Skv, d, kv_len, int(bool(causal)), int(window),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check_launch(lib, code, "flash_attention")
    launch_count += 1
    return o
