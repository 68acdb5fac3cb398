"""Decode attention (flash-decoding): one new query token per sequence
against its KV cache, with a valid length per sequence.

``decode_attention`` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors and uses the plain
PyTorch version ``decode_attention_ref`` only for tensors that lie on
the CPU.  Counterpart of ``repro/kernels/decode_attention.py``; the
plain version mirrors ``repro/kernels/ref.py::decode_attention_ref``.

The kernel reads the cache in its own layout, so the wrapper makes no
copy of it (a narrowed view ``cache[:, lo:hi]`` costs nothing):

  q (B, Hq, d); k, v (B, Skv, Hkv, d) with ``head_dim`` contiguous;
  lengths (B,) int32 — sequence ``b`` attends to keys [0, lengths[b]).
  Query head ``h`` reads kv head ``h // (Hq / Hkv)``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches made by ``decode_attention`` in this process
#: (incremented where the kernel is launched, and nowhere else)
launch_count = 0

#: the dtypes the kernel takes, with their code in the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 16
#: warps of a block of the bf16 kernel, each with its own run of a split's
#: keys, and the keys a warp stages at a time (csrc/decode_attention.cu)
WARPS = 4
KEYS_PER_TILE = 16
#: blocks the kv split aims for: four a streaming multiprocessor of an
#: H100 (132 of them; four bf16 blocks fit one at head_dim 128), so that
#: B * Hkv alone need not fill the card
TARGET_BLOCKS = 4 * 132


def decode_attention_ref(q, k, v, lengths, *, softmax_scale=None):
    """Plain PyTorch version: fp32 scores, keys at or past the valid
    length masked to -1e30, one softmax, output in q's dtype.

    Takes the reference's layout — q (BHkv, G, d), k and v (BHkv, Skv,
    d), lengths (BHkv, 1) — or the cache layout of ``decode_attention``
    — q (B, Hq, d), k and v (B, Skv, Hkv, d), lengths (B,) — which it
    folds into the former.
    """
    if k.dim() == 4:
        B, Skv, Hkv, d = k.shape
        G = q.shape[1] // Hkv
        o = decode_attention_ref(
            q.reshape(B * Hkv, G, d),
            k.transpose(1, 2).reshape(B * Hkv, Skv, d),
            v.transpose(1, 2).reshape(B * Hkv, Skv, d),
            lengths.reshape(B, 1).expand(B, Hkv).reshape(B * Hkv, 1),
            softmax_scale=softmax_scale)
        return o.reshape(B, Hkv * G, d)
    BH, G, d = q.shape
    Skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    s = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) * scale
    mask = (torch.arange(Skv, device=q.device)[None, :]
            < lengths.reshape(BH, 1))                    # (BH, Skv)
    s = torch.where(mask[:, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgk,bkd->bgd", p, v.float())
    return o.to(q.dtype)


def split_plan(bh: int, skv: int) -> Tuple[int, int]:
    """(keys a split, number of splits) of the kv axis: about
    ``TARGET_BLOCKS`` blocks over ``bh`` (batch x kv heads), each split a
    whole number of ``WARPS`` x ``KEYS_PER_TILE`` keys (a tile for each
    warp at least; also a whole number of the fp32 kernel's tiles of 32
    and 16)."""
    unit = WARPS * KEYS_PER_TILE
    want = max(1, math.ceil(TARGET_BLOCKS / bh))
    chunk = math.ceil(max(unit, math.ceil(skv / want)) / unit) * unit
    return chunk, math.ceil(skv / chunk)


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: expected q (B,Hq,d), k and v "
                         f"(B,Skv,Hkv,d) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Skv, Hkv, d = k.shape
    if q.shape[0] != B or q.shape[2] != d or q.shape[1] % Hkv != 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the cache {tuple(k.shape)}")
    if q.shape[1] // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {q.shape[1] // Hkv} query "
                         f"heads a kv head, at most {MAX_GROUP}")
    if B == 0 or Skv == 0:
        raise ValueError("decode_attention: empty batch or cache")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("decode_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 != 0 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {d} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,)
            or not lengths.is_contiguous()):
        raise ValueError("decode_attention: lengths must be a contiguous "
                         f"(B,) = ({B},) int32 tensor, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous and "
                         "16-byte aligned")
    size = k.element_size()
    for name, t in (("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s * size % 16 for s in t.stride()[:3])):
            raise ValueError(f"decode_attention: {name} must have head_dim "
                             "contiguous, a 16-byte aligned start and "
                             f"strides of whole 16 bytes, got strides "
                             f"{t.stride()}")


def decode_attention(q, k, v, lengths, *, softmax_scale=None):
    """q (B, Hq, d); k, v (B, Skv, Hkv, d); lengths (B,) int32 -> o (B,
    Hq, d) in q's dtype.  A length above Skv counts as Skv; a sequence of
    length 0 gets zeros on the card.

    CPU tensors go to the plain version.  CUDA tensors go to the kernel,
    on the current stream and without synchronising, or this raises: it
    never falls back.  On CUDA tensors it also raises when autograd would
    follow an input: the kernel has no backward (decode is never
    differentiated).
    """
    global launch_count
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"decode_attention: unsupported device "
                             f"{q.device}")
        return decode_attention_ref(q, k, v, lengths,
                                    softmax_scale=softmax_scale)
    _build.refuse_grad("decode_attention", q, k, v)
    _check(q, k, v, lengths)
    B, Skv, Hkv, d = k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    chunk, n_splits = split_plan(B * Hkv, Skv)
    lib = _build.load_library()
    o = torch.empty_like(q)
    part_acc = torch.empty((B * Hkv, n_splits, G, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * Hkv, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            B, Hq, Hkv, Skv, d, *k.stride()[:3], *v.stride()[:3],
            chunk, n_splits, float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check_launch(lib, code, "decode_attention")
    launch_count += 1
    return o
