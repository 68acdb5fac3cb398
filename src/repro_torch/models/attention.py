"""Attention: GQA/MQA/MHA, causal / sliding-window / cross, chunked softmax,
and the KV caches of decode.

Counterpart of ``repro/models/attention.py``.  Execution paths with
identical math:
  * ``attention_einsum`` — plain einsum; fine for short sequences.
  * ``attention_chunked`` — a loop over KV chunks with an online softmax;
    never materializes the (Sq, Skv) score matrix.
  * on a CUDA tensor, ``self_attention`` and ``cross_attention`` run
    the hand-written flash kernel (``kernels/csrc/flash_attention.cu``)
    at every length.  The reference's ``self_attention`` reaches only its
    ``lax.scan`` mirror, never its Pallas kernel, and its cross-attention
    calls ``attend``; on CPU tensors the port keeps the reference's
    dispatch (einsum below ``flash_min_len``, the chunked online softmax
    at and above it; ``attend`` for cross-attention).

Shapes: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq % Hkv == 0.
"""
from __future__ import annotations

import torch

from repro_torch.compat import DeviceLike, resolve_device
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


def kv_heads_for(k, v, q_first: int, n_q: int, group: int):
    """The kv heads that the global query heads ``[q_first, q_first +
    n_q)`` read, laid out for those ``n_q`` heads alone: GQA pairs query
    head ``h`` with kv head ``h // group``, and every path here (the
    kernels included) pairs local query head ``j`` with kv head ``j //
    (n_q / n_kv)`` of what it is given.  Where the heads' kv heads are
    each read by an equal, consecutive run of them, that run of ``k`` and
    ``v``'s head axis (axis 2) is returned as views; where they straddle
    groups unevenly (6 query heads on 3 kv heads, 3 of them a rank: kv
    heads 0, 0, 1 and 1, 2, 2), one kv head a query head, copied."""
    owner = [(q_first + j) // group for j in range(n_q)]
    n_kv = owner[-1] - owner[0] + 1
    if n_q % n_kv == 0 and owner == [owner[0] + j // (n_q // n_kv)
                                     for j in range(n_q)]:
        return k.narrow(2, owner[0], n_kv), v.narrow(2, owner[0], n_kv)
    index = torch.tensor(owner, device=k.device)
    return k.index_select(2, index), v.index_select(2, index)


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
    """The reference's ``flash_self_attention`` on CPU tensors (positions
    are ``arange(S)``, ``Skv`` a multiple of the chunk): the chunked
    online softmax, which autograd follows through its loop.  On CUDA
    tensors ``self_attention`` takes the flash kernel, whose backward
    transcribes the reference's custom one."""
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


def cross_attention(q, k, v, *, q_positions):
    """Encoder-decoder cross-attention: every query sees every key, no
    RoPE.  q (B, Sq, Hq, D) from the decoder, k and v (B, Skv, Hkv, D)
    from the encoder, Sq and Skv unrelated.  CUDA tensors: the flash
    kernel, non-causal.  CPU tensors: ``attend`` as the reference calls
    it, the keys at ``arange(Skv)``."""
    if q.is_cuda:
        return ops.flash_attention(q, k, v, causal=False, window=0)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    return attend(q, k, v, q_positions=q_positions, kv_positions=kv_pos,
                  causal=False, window=0)


# --------------------------------------------------------------------------
# KV caches
# --------------------------------------------------------------------------
# The reference updates a cache functionally (``dynamic_update_slice``
# returns a new array, so a step copies the whole cache unless XLA
# donates it).  Here the new row is written into the cache's tensors in
# place and the same dict is returned: a decode step then moves one row
# per layer, not the cache.
def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                  quantized: bool = False, device: DeviceLike = None):
    """Zero cache on ``device`` (``None`` = the GPU).  ``quantized``: int8
    values with one fp32 scale per (position, head) row."""
    dev = resolve_device(device)
    shape = (batch, max_len, n_kv, head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:3] + (1,), device=dev),
            "v_scale": torch.zeros(shape[:3] + (1,), device=dev),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _quantize_rows(x):
    """x (..., D) -> (int8 values, fp32 scales (..., 1))."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def dequantize_cache(cache):
    """-> (k, v) as fp32 (from int8 + scales) or the cache's own tensors."""
    if "k_scale" in cache:
        return (cache["k"].float() * cache["k_scale"],
                cache["v"].float() * cache["v_scale"])
    return cache["k"], cache["v"]


def _maybe_quantize_new(cache, k_new, v_new):
    if "k_scale" in cache:
        return _quantize_rows(k_new), _quantize_rows(v_new)
    return (k_new, None), (v_new, None)


def _write(cache, slot: int, kq, ks, vq, vs):
    """Rows ``[slot, slot + S_new)`` of every tensor of ``cache``, in
    place.  Unlike the reference's ``dynamic_update_slice``, which clamps
    the slot so that the update fits, a slot past the end raises."""
    n = kq.shape[1]
    if not 0 <= slot <= cache["k"].shape[1] - n:
        raise ValueError(f"cache write at {slot} of {n} rows outside a "
                         f"cache of {cache['k'].shape[1]}")
    cache["k"][:, slot:slot + n] = kq
    cache["v"][:, slot:slot + n] = vq
    if ks is not None:
        cache["k_scale"][:, slot:slot + n] = ks
        cache["v_scale"][:, slot:slot + n] = vs
    return cache


def cache_update_ring(cache, k_new, v_new, position: int):
    """Write one step into a ring buffer of length W (SWA / local
    attention) at slot ``position % W``, ``position`` being the new
    token's global position.  Returns the same, updated cache."""
    W = cache["k"].shape[1]
    (kq, ks), (vq, vs) = _maybe_quantize_new(cache, k_new, v_new)
    return _write(cache, int(position) % W, kq, ks, vq, vs)


def ring_positions(window: int, position):
    """Global position held in each ring slot at decode step ``position``
    (an int, or a 0-d tensor whose device the results take): slot s holds
    the latest p <= position with p % W == s; slots not yet written
    (p < 0) are invalid.  Returns (positions, valid)."""
    position = torch.as_tensor(position)
    slots = torch.arange(window, device=position.device)
    delta = torch.remainder(torch.remainder(position, window) - slots, window)
    pos = position - delta
    return pos, pos >= 0


def cache_update_linear(cache, k_new, v_new, position: int):
    """Write one step into a full-length cache at index ``position``."""
    (kq, ks), (vq, vs) = _maybe_quantize_new(cache, k_new, v_new)
    return _write(cache, int(position), kq, ks, vq, vs)
