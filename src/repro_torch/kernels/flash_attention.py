"""Prefill flash attention in the kernel layout, and its backward.

``flash_attention`` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors and uses the plain PyTorch
version ``flash_attention_ref`` only for tensors that lie on the CPU.
Counterpart of ``repro/kernels/flash_attention.py``; the plain version
mirrors ``repro/kernels/ref.py::flash_attention_ref``.

Under autograd it runs as ``FlashAttention``, a ``torch.autograd.Function``
whose forward is the same dispatch with the row log-sum-exp kept (the
kernel writes it on request; the bf16 kernel has no lse at d > 128,
where its epilogue would spill, so there the card refuses autograd) and
whose backward, ``flash_attention_bwd``,
transcribes the reference's ``repro/models/attention.py::_flash_bwd_impl``
(the reference has no Pallas backward): a chunked recompute of the
probabilities from ``(q, k, v, o, lse)``, device-agnostic torch code, so
the CPU runs the backward the card runs.

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
#: queries and keys a tile of the backward (the reference's chunk)
BWD_CHUNK = 1024


def _masked_scores(s, q0, k0, *, causal, window, kv_len):
    """Scores s (..., Sq', Skv') of queries from q0 and keys from k0,
    -1e30 where a key is past ``kv_len``, in the future (causal) or
    outside the window."""
    q_pos = torch.arange(q0, q0 + s.shape[-2], device=s.device)[:, None]
    k_pos = torch.arange(k0, k0 + s.shape[-1], device=s.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return torch.where(mask, s, torch.full((), NEG_INF, device=s.device))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len: Optional[int] = None, softmax_scale=None,
                        return_lse: bool = False):
    """Plain PyTorch version, same layout: the whole score matrix in fp32,
    masked to -1e30, one softmax, output in q's dtype; with
    ``return_lse``, also the rows' log-sum-exp (BHq, Sq) fp32."""
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    group = BHq // BHkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(BHkv, group, Sq, d).float()
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    s = _masked_scores(s, 0, 0, causal=causal, window=window, kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    o = o.reshape(BHq, Sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(BHq, Sq)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, window: int,
                        kv_len: int, scale: float):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, output ``o``,
    row log-sum-exp ``lse`` (BHq, Sq) fp32 and the output's cotangent
    ``do``, in the kernel layout.  The reference's ``_flash_bwd_impl``:
    per tile of ``BWD_CHUNK`` queries and keys, p = exp(s - lse),
    dv += p^T do, dp = do v^T, ds = p (dp - delta) scale, dq += ds k,
    dk += ds^T q, all in fp32, with delta = sum(do * o) over d.  Tiles
    that every mask hides are skipped (their p is 0).  The reference
    takes delta from its fp32 o; here o is the forward's output in q's
    dtype, upcast.  GQA: a kv head's dk and dv sum over its q heads."""
    chunk = BWD_CHUNK
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    G = BHq // BHkv
    qg = q.reshape(BHkv, G, Sq, d).float()
    dog = do.reshape(BHkv, G, Sq, d).float()
    lse = lse.reshape(BHkv, G, Sq, 1)
    delta = (dog * o.reshape(BHkv, G, Sq, d).float()).sum(-1, keepdim=True)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((BHkv, Skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, min(Skv, kv_len), chunk):
        k1 = min(Skv, k0 + chunk)
        kc, vc = k[:, k0:k1].float(), v[:, k0:k1].float()
        for q0 in range(0, Sq, chunk):
            q1 = min(Sq, q0 + chunk)
            if (causal and k0 > q1 - 1) or (window and k1 - 1 <= q0 - window):
                continue
            qt, dot = qg[:, :, q0:q1], dog[:, :, q0:q1]
            s = torch.einsum("bgqd,bkd->bgqk", qt, kc) * scale
            s = _masked_scores(s, q0, k0, causal=causal, window=window,
                               kv_len=kv_len)
            p = torch.exp(s - lse[:, :, q0:q1])
            dv[:, k0:k1] += torch.einsum("bgqk,bgqd->bkd", p, dot)
            dp = torch.einsum("bgqd,bkd->bgqk", dot, vc)
            ds = p * (dp - delta[:, :, q0:q1]) * scale
            dq[:, :, q0:q1] += torch.einsum("bgqk,bkd->bgqd", ds, kc)
            dk[:, k0:k1] += torch.einsum("bgqk,bgqd->bkd", ds, qt)
    return (dq.reshape(BHq, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def _launch(q, k, v, *, causal: bool, window: int, kv_len: int,
            scale: float, want_lse: bool):
    """One launch of the kernel on checked CUDA tensors -> (o, lse or
    None), on the current stream, without synchronising."""
    global launch_count
    BHq, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    if want_lse and q.dtype == torch.bfloat16 and d > 128:
        raise RuntimeError(f"flash_attention: no backward for bfloat16 at "
                           f"head_dim {d} on the card: the kernel writes "
                           f"no lse above 128")
    lib = _build.load_library()
    o = torch.empty_like(q)
    lse = (torch.empty((BHq, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if Sq == 0:
        return o, (torch.empty((BHq, 0), device=q.device) if want_lse
                   else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            BHq, BHkv, Sq, Skv, d, kv_len, int(bool(causal)), int(window),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check_launch(lib, code, "flash_attention")
    launch_count += 1
    return o, lse


def _forward(q, k, v, *, causal, window, kv_len, scale, want_lse):
    """The dispatch: the plain version on CPU tensors, the kernel on CUDA
    tensors (or a raise).  Returns (o, lse or None)."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len, softmax_scale=scale,
                                  return_lse=want_lse)
        return out if want_lse else (out, None)
    _check(q, k, v, kv_len)
    return _launch(q, k, v, causal=causal, window=window, kv_len=kv_len,
                   scale=scale, want_lse=want_lse)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward keeps (q, k, v, o,
    lse), the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, scale):
        o, lse = _forward(q, k, v, causal=causal, window=window,
                          kv_len=kv_len, scale=scale, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, kv_len=kv_len,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, softmax_scale=None):
    """q (BHq, Sq, d); k, v (BHkv, Skv, d) -> o (BHq, Sq, d) in q's dtype.

    CPU tensors go to the plain version.  CUDA tensors go to the kernel,
    on the current stream and without synchronising, or this raises: it
    never falls back.  When grad is enabled and an input requires it,
    the call runs as ``FlashAttention``, whose backward is torch code
    (refused on the card for bfloat16 at head_dim > 128).
    """
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    scale = softmax_scale if softmax_scale is not None else q.shape[2] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    kv_len, float(scale))
    return _forward(q, k, v, causal=causal, window=window, kv_len=kv_len,
                    scale=scale, want_lse=False)[0]
