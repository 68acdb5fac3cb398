"""Attention: GQA/MQA/MHA, causal / sliding-window / cross, chunked softmax.

Counterpart of ``repro/models/attention.py`` (full-sequence paths; the
KV caches come with decode).  Execution paths with identical math:
  * ``attention_einsum`` — plain einsum; fine for short sequences.
  * ``attention_chunked`` — a loop over KV chunks with an online softmax;
    never materializes the (Sq, Skv) score matrix.
  * on a CUDA tensor, ``self_attention`` runs the hand-written flash
    kernel (``kernels/csrc/flash_attention.cu``) at every length.  The
    reference's ``self_attention`` reaches only its ``lax.scan`` mirror,
    never its Pallas kernel; on CPU tensors the port keeps the
    reference's dispatch (einsum below ``flash_min_len``, the chunked
    online softmax at and above it).

Shapes: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq % Hkv == 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _mask(q_pos, kv_pos, *, causal: bool, window: int, kv_valid=None):
    """Boolean mask (..., Sq, Skv): True = attend."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], kv_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    if kv_valid is not None:
        m = m & kv_valid[..., None, :]
    return m


def _gqa_scores(q, k):
    """q (B,Sq,Hkv,G,D) x k (B,Skv,Hkv,D) -> (B,Hkv,G,Sq,Skv) in fp32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def attention_einsum(q, k, v, *, q_positions, kv_positions, causal=True,
                     window=0, kv_valid=None, softmax_scale=None):
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = _gqa_scores(qg, k) * scale                       # (B,Hkv,G,Sq,Skv)
    mask = _mask(q_positions, kv_positions, causal=causal, window=window,
                 kv_valid=kv_valid)                      # (B?,Sq,Skv)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, D)


def attention_chunked(q, k, v, *, q_positions, kv_positions, causal=True,
                      window=0, kv_valid=None, softmax_scale=None,
                      chunk_size=1024):
    """Online-softmax attention, looping over KV chunks (flash-style)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    chunk = min(chunk_size, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    dev = q.device
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
        valid_pad = torch.arange(n_chunks * chunk, device=dev) < Skv
        kv_valid = (valid_pad if kv_valid is None else
                    torch.nn.functional.pad(kv_valid, (0, pad)) & valid_pad)
    if kv_valid is not None and kv_valid.dim() == 1:
        kv_valid = kv_valid[None]                        # (1, Skv)

    qg = q.reshape(B, Sq, Hkv, G, D)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = _gqa_scores(qg, k[:, sl]) * scale            # (B,Hkv,G,Sq,chunk)
        msk = _mask(q_positions, kv_positions[sl], causal=causal,
                    window=window)
        if kv_valid is not None:
            msk = msk & kv_valid[:, None, sl]            # (B|1,Sq,chunk)
        s = torch.where(msk[:, None, None] if msk.dim() == 3
                        else msk[None, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, sl].float())
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attend(q, k, v, *, q_positions, kv_positions, causal=True, window=0,
           kv_valid=None, chunked=None, chunk_size=1024):
    """Dispatch: chunked for long KV (memory-safe), einsum otherwise."""
    if chunked is None:
        chunked = k.shape[1] > 2048 and q.shape[1] > 1
    fn = attention_chunked if chunked else attention_einsum
    kwargs = dict(q_positions=q_positions, kv_positions=kv_positions,
                  causal=causal, window=window, kv_valid=kv_valid)
    if chunked:
        kwargs["chunk_size"] = chunk_size
    return fn(q, k, v, **kwargs)


def flash_self_attention(q, k, v, causal=True, window=0, chunk_size=1024):
    """Forward of the reference's ``flash_self_attention`` (positions are
    ``arange(S)``, ``Skv`` a multiple of the chunk): the chunked online
    softmax.  Its custom backward is training work (ROADMAP A9)."""
    chunk = min(chunk_size, k.shape[1])
    if k.shape[1] % chunk:
        raise ValueError(f"kv length {k.shape[1]} is not a multiple of the "
                         f"chunk {chunk}")
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    return attention_chunked(q, k, v, q_positions=q_pos, kv_positions=kv_pos,
                             causal=causal, window=window, chunk_size=chunk)


def self_attention(q, k, v, *, causal=True, window=0, chunk_size=1024,
                   flash_min_len: int = 2048):
    """Prefill self-attention (positions ``arange(S)``).  CUDA tensors:
    the hand-written flash kernel.  CPU tensors: the reference's
    dispatch — chunked online softmax for long sequences, einsum for
    short ones."""
    if q.is_cuda:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    S = q.shape[1]
    if S >= flash_min_len and S % min(chunk_size, S) == 0:
        return flash_self_attention(q, k, v, causal, window, chunk_size)
    pos = torch.arange(S, device=q.device)
    return attention_einsum(q, k, v, q_positions=pos, kv_positions=pos,
                            causal=causal, window=window)
