"""Dry run of the port: the roofline record of every (arch x shape) cell,
counted from the port's own step.

The reference (``repro/launch/dryrun.py``) lowers each cell through XLA
on 256 or 512 host devices and counts the HLO text it produces
(``roofline.hlo_parser``).  The port has no compiler to ask, so it keeps
what that module produces and replaces how: ``count_cell`` counts one
step of the port's own program on one device -- ``make_train_step``,
``transformer.prefill`` or ``transformer.decode_step`` as they run on a
CUDA tensor, through the hand kernels -- from the parameter tree built on
the ``meta`` device and the config.  Nothing is allocated and nothing
runs on a device: the whole sweep is host arithmetic, and this module
imports nothing that sets up a GPU.

What is counted (``components`` of a record):
  * FLOPs: matrix products (2 per multiply-add) and the scans' own work.
    Elementwise work (norms, activations, softmax, AdamW) counts bytes
    only.  The flash kernel visits only the (query, key) pairs that the
    causal, window and ``kv_len`` masks allow; its backward (torch code)
    computes every tile of ``BWD_CHUNK`` rows that one of those pairs
    touches; decode attention reads ``position + 1`` rows, or the window.
  * bytes: HBM traffic -- weights at their dtype in every pass, each
    kernel's inputs and outputs by the reference's formulas
    (``repro/launch/perf.py``, its ``flash_vmem`` accounting: a kernel's
    interior stays on chip), activations at block boundaries, the logits
    of the loss, the KV cache or state at decode, AdamW's state at train.
  * collective bytes: 0 -- the port runs on one device (ROADMAP A10).

``build_prefill_step`` and ``build_decode_step`` are the reference's
step builders, as eager functions: over a mesh of ``torch.distributed``
ranks each rank calls them on its ``param_specs`` blocks and its rows
(dense tensor parallelism, ``models/transformer.py``).

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --capacity-out capacity.json
"""
import argparse
import json
import math
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPE_CELLS, ShapeCell,
                                 cell_by_name, get_config)
from repro_torch.convert import tree_leaves
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import BWD_CHUNK
from repro_torch.models import transformer as tr
from repro_torch.models.common import pdtype
from repro_torch.models.moe import _capacity
from repro_torch.roofline.analysis import (PEAK_FLOPS, dominant_term,
                                           model_flops, r_cloud_estimates,
                                           roofline_terms)

META = torch.device("meta")
#: the mesh a record of the port names: one device
MESH = "1"


class ShapeDtype(NamedTuple):
    """Shape-only stand-in for one input (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# --------------------------------------------------------------------------
# Shape-only inputs (meta tensors and stand-ins: no allocation)
# --------------------------------------------------------------------------
def param_shapes(cfg):
    """The port's ``init_params`` on the meta device: every leaf has its
    shape and dtype, and nothing is drawn."""
    return tr.init_params(cfg, torch.Generator(), META)


def batch_shapes(cfg, batch: int, seq: int) -> Dict[str, Any]:
    """Training/prefill batch stand-ins for one architecture."""
    out: Dict[str, Any] = {}
    if cfg.encoder_layers:
        enc_len = min(cfg.frontend.num_positions if cfg.frontend else 1024,
                      seq)
        out["tokens"] = ShapeDtype((batch, seq), torch.int32)
        out["frontend"] = ShapeDtype(
            (batch, enc_len, cfg.frontend.embed_dim if cfg.frontend
             else cfg.d_model), torch.float32)
    elif cfg.frontend is not None:
        P = cfg.frontend.num_positions
        out["tokens"] = ShapeDtype((batch, seq - P), torch.int32)
        out["frontend"] = ShapeDtype(
            (batch, P, cfg.frontend.embed_dim), torch.float32)
    else:
        out["tokens"] = ShapeDtype((batch, seq), torch.int32)
    out["labels"] = ShapeDtype((batch, seq), torch.int32)
    out["mask"] = ShapeDtype((batch, seq), torch.int32)
    return out


def _enc_len(cfg) -> int:
    return cfg.frontend.num_positions if cfg.frontend else 1024


def decode_input_shapes(cfg, batch: int, seq: int, params=None):
    """(token, cache, position): the cache is the port's
    ``init_decode_cache`` on the meta device, with an encoder-decoder's
    ``enc_kv`` built from a meta encoder output."""
    cache = tr.init_decode_cache(cfg, batch, seq, device=META)
    if cfg.encoder_layers:
        enc_out = torch.empty((batch, _enc_len(cfg), cfg.d_model),
                              dtype=torch.bfloat16, device=META)
        params = param_shapes(cfg) if params is None else params
        cache["enc_kv"] = tr.build_enc_kv(params, enc_out, cfg)
    token = ShapeDtype((batch, 1), torch.int32)
    position = ShapeDtype((), torch.int32)
    return token, cache, position


def input_specs(arch: str, cell_name: str):
    """Public API: shape stand-ins for every model input."""
    cfg = get_config(arch)
    cell = cell_by_name(cell_name)
    if cell.kind in ("train", "prefill"):
        return batch_shapes(cfg, cell.global_batch, cell.seq_len)
    return decode_input_shapes(cfg, cell.global_batch, cell.seq_len)


def cell_supported(cfg, cell) -> Tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.is_sub_quadratic():
        return False, "SKIP(full-attn): 524k decode needs sub-quadratic state"
    return True, ""


# --------------------------------------------------------------------------
# The count
# --------------------------------------------------------------------------
#: leaves of a block that multiply the tokens of its own stream
_TOKEN_PRODUCTS = {"wq", "wk", "wv", "wo", "xwq", "xwo", "wi", "wi_gate",
                   "wi_up", "w_rec_in", "w_gate_in", "wa", "wx", "w_out",
                   "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj",
                   "out_proj", "router"}
#: leaves of a decoder block that multiply the encoder's output
_ENCODER_PRODUCTS = {"xwk", "xwv"}
#: a Mixture-of-Experts layer's experts: (E, d, f) or (E, f, d)
_EXPERTS = {"w_gate", "w_up", "w_in", "w_down"}
#: the components whose bytes are the kernels' inputs and outputs
KERNEL_IO = ("attention", "encoder_attention", "rglru_scan", "ssd_scan",
             "moe_dispatch")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree))


def causal_pairs(Sq: int, Skv: int, *, causal: bool, window: int,
                 kv_len: Optional[int] = None) -> int:
    """(query, key) pairs that the masks let the flash kernel visit:
    query i (at position i) sees keys j < kv_len with j <= i (causal)
    and j > i - window (window > 0)."""
    kv_len = Skv if kv_len is None else kv_len
    if not causal:
        return Sq * kv_len
    total = 0
    for i in range(min(Sq, kv_len)):      # rows past kv_len see kv_len keys
        lo = max(0, i - window + 1) if window else 0
        total += i + 1 - lo
    for i in range(min(Sq, kv_len), Sq):
        lo = max(0, i - window + 1) if window else 0
        total += max(0, kv_len - lo)
    return total


def bwd_tile_pairs(Sq: int, Skv: int, *, causal: bool, window: int,
                   chunk: int = BWD_CHUNK) -> int:
    """(query, key) pairs the flash backward computes: every pair of each
    tile of ``chunk`` queries and keys that it does not skip
    (``kernels/flash_attention.py::flash_attention_bwd``)."""
    total = 0
    for k0 in range(0, Skv, chunk):
        k1 = min(Skv, k0 + chunk)
        for q0 in range(0, Sq, chunk):
            q1 = min(Sq, q0 + chunk)
            if (causal and k0 > q1 - 1) or (window and k1 - 1 <= q0 - window):
                continue
            total += (q1 - q0) * (k1 - k0)
    return total


# --------------------------------------------------------------------------
# Step builders (the reference's names and returns)
# --------------------------------------------------------------------------
def build_prefill_step(cfg, mesh):
    """``(prefill_step, ctx)``: ``prefill_step(params, batch)`` returns
    ``transformer.prefill``'s (last-token logits, cache) under ``mesh``
    (``None``: one device).  Over a model axis above 1, ``params`` are
    this rank's ``param_specs`` blocks and ``batch`` its ``batch_specs``
    rows; the logits come back whole."""
    ctx = shd.make_ctx(mesh)

    def prefill_step(params, batch):
        return tr.prefill(params, batch, cfg, ctx)

    return prefill_step, ctx


def build_decode_step(cfg, mesh):
    """``(decode, ctx)``: ``decode(params, token, cache, position)`` is
    ``transformer.decode_step`` under ``mesh``; the cache is this rank's
    (its rows, and its kv heads where they divide the model axis),
    updated in place."""
    ctx = shd.make_ctx(mesh)

    def decode(params, token, cache, position):
        return tr.decode_step(params, token, cache, position, cfg, ctx)

    return decode, ctx


def _block_leaves(params):
    """(stream, remat, kind-free path, leaf) of every block leaf: stream
    is "dec" (decoder/LM blocks) or "enc" (encoder blocks); remat tells a
    group-stacked or encoder leaf (recomputed in the backward pass) from
    a tail leaf (kept)."""
    for stack, remat in (("blocks", True), ("tail", False)):
        for path, t in _paths(params.get(stack, {})):
            yield "dec", remat, path, t
    if "encoder" in params:
        for path, t in _paths(params["encoder"]["blocks"]):
            yield "enc", True, path, t


def count_cell(cfg, cell: ShapeCell, *, n_micro: int = 1,
               micro_mode: str = "accum", grad_acc_bytes: int = 4,
               position: Optional[int] = None, params=None) -> Dict:
    """FLOPs, HBM bytes and collective bytes of one step of the port's
    program on one device at ``cell``'s shape (any ``ShapeCell``, also
    one built at a size one card holds).

    train: ``make_train_step`` -- forward, each group's blocks and the
    loss's chunks recomputed in the backward pass, a backward of two
    products per forward product, AdamW over fp32 masters.  ``n_micro``
    > 1 counts the reference's microbatched step (``micro_mode``
    "accum": gradients summed into a ``grad_acc_bytes`` buffer after each
    microbatch; "loss": each microbatch's forward recomputed once more
    under one checkpoint, gradients summed in the backward pass).
    prefill: ``transformer.prefill`` of ``seq_len`` tokens, last-token
    logits.  decode: one ``decode_step`` at ``position`` (default the
    cache's last row, ``seq_len - 1``) through a cache of ``seq_len``
    rows.  Returns {"flops", "bytes", "collective_bytes",
    "components": {name: {"flops", "bytes"}}}."""
    if micro_mode not in ("accum", "loss"):
        raise ValueError(f"micro_mode {micro_mode!r}")
    if n_micro < 1 or cell.global_batch % n_micro:
        raise ValueError(f"{n_micro} microbatches do not divide a batch "
                         f"of {cell.global_batch}")
    params = param_shapes(cfg) if params is None else params
    kind, B, S = cell.kind, cell.global_batch, cell.seq_len
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"cell kind {kind!r}")
    train, decode = kind == "train", kind == "decode"
    el = torch.empty((), dtype=pdtype(cfg)).element_size()
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    Vp = cfg.padded_vocab()
    kinds = list(cfg.pattern_for_layers())
    G = cfg.num_groups()
    # which layers are group-stacked (recomputed at train) and which tail
    n_grouped = {k: G * cfg.block_pattern.count(k) for k in set(kinds)}
    n_tail = {k: cfg.tail_pattern().count(k) for k in set(kinds)}
    enc_len = 0
    if cfg.encoder_layers:
        enc_len = _enc_len(cfg) if decode else min(_enc_len(cfg), S)
    P_front = (cfg.frontend.num_positions
               if cfg.frontend is not None and not cfg.encoder_layers
               and not decode else 0)
    window = cfg.window if cfg.attention_kind == "swa" else 0
    comps: Dict[str, Dict[str, float]] = {}

    def add(name: str, flops: float, bytes_: float) -> None:
        c = comps.setdefault(name, {"flops": 0.0, "bytes": 0.0})
        c["flops"] += float(flops)
        c["bytes"] += float(bytes_)

    # one call is one microbatch: the tokens of each stream in it
    Bm = B // n_micro if train else B
    T = Bm * (1 if decode else S)
    T_enc = Bm * enc_len if not decode else 0
    calls = n_micro if train else 1
    # forward passes a call: the loss mode recomputes the whole forward
    fw = 2.0 if (train and n_micro > 1 and micro_mode == "loss") else 1.0

    # ---- weight products (and the MoE experts at capacity) -------------
    for stream, remat, path, t in _block_leaves(params):
        if stream == "enc" and decode:
            continue                       # no encoder at decode
        name = path[-1]
        # forward, the group's recompute (remat leaves), the backward's two
        rm = 1.0 if (train and remat) else 0.0
        bw = 2.0 if train else 0.0
        if "moe" in path and name in _EXPERTS:
            n_tok = T_enc if stream == "enc" else T
            cap = _capacity(n_tok, cfg.moe.top_k, cfg.moe.num_experts,
                            cfg.moe.capacity_factor)
            add("moe_experts", calls * 2.0 * cap * t.numel() * (fw + rm + bw),
                calls * _nbytes(t) * (fw + rm + bw))
            continue
        f_pass = 0.0
        if name in _ENCODER_PRODUCTS:
            f_pass = 2.0 * T_enc * t.numel()   # decode reads enc_kv instead
        elif name in _TOKEN_PRODUCTS:
            f_pass = 2.0 * (T_enc if stream == "enc" else T) * t.numel()
        read = _nbytes(t)
        add("weights_forward", calls * f_pass * fw, calls * read * fw)
        if train:
            add("weights_recompute", calls * f_pass * rm, calls * read * rm)
            # the backward reads each weight and writes its gradient
            add("weights_backward", calls * f_pass * bw, calls * 2 * read)
    if "frontend_proj" in params and not decode:
        t = params["frontend_proj"]
        rows = Bm * (P_front or enc_len)
        add("weights_forward", calls * 2.0 * rows * t.numel() * fw,
            calls * _nbytes(t) * fw)
        if train:
            add("weights_backward", calls * 4.0 * rows * t.numel(),
                calls * 2 * _nbytes(t))
    if kind == "prefill" and cfg.encoder_layers:
        # prefill projects the cross K/V once more for the decode cache
        for stream, remat, path, t in _block_leaves(params):
            if stream == "dec" and path[-1] in _ENCODER_PRODUCTS:
                add("weights_forward", 2.0 * T_enc * t.numel(), _nbytes(t))

    # ---- embedding and head ---------------------------------------------
    emb = params["embed"]
    n_text = T - Bm * P_front
    add("embedding", 0.0, calls * fw * 2 * n_text * d * el)
    if train:
        # the gather's backward writes a dense gradient of the table
        add("embedding", 0.0, calls * (n_text * d * el + _nbytes(emb)))
    w_head = emb if cfg.tie_embeddings else params["lm_head"]
    rows = T if train else Bm      # the loss's every row, or last tokens
    f_head = 2.0 * rows * d * Vp
    logits = rows * Vp * (el + 4)  # the product's output and its fp32 copy
    if train:
        # forward, the chunk's recompute, the backward's two products
        add("head", calls * f_head * (fw + 1 + 2),
                  calls * ((fw + 1) * (_nbytes(w_head) + logits)
                           + 2 * _nbytes(w_head) + logits))
    else:
        add("head", f_head, _nbytes(w_head) + logits)

    # ---- attention ------------------------------------------------------
    n_attn_g, n_attn_t = n_grouped.get("attn", 0), n_tail.get("attn", 0)
    n_attn = n_attn_g + n_attn_t
    cross = cfg.encoder_layers > 0
    if decode:
        pos = S - 1 if position is None else int(position)
        if not 0 <= pos < S:
            raise ValueError(f"position {pos} outside a cache of {S} rows")
        n = min(pos + 1, window) if window else pos + 1
        f = 4.0 * B * Hq * hd * n * n_attn
        cache_el = 2 if cfg.kv_cache_dtype != "int8" else None
        L = cfg.effective_kv_len(S)
        if cache_el is not None:
            by = 2.0 * n_attn * B * n * Hkv * hd * cache_el
            write = 2.0 * n_attn * B * Hkv * hd * cache_el
        else:
            # dequantize_cache runs over every row: int8 read, an fp32
            # copy, its product with the scales, a bf16 copy; the kernel
            # then reads n rows
            per = 1 + 4 + 4 + 4 + 4 + el
            scales = 2 * 4 * 2                 # scale read, fp32 product
            by = n_attn * B * Hkv * (2.0 * L * hd * per + 2 * L * scales
                                     + 2.0 * n * hd * el)
            write = n_attn * B * Hkv * 2.0 * (hd + 4)
        add("attention", f, by)
        add("cache", 0.0, write)
        if cross:
            add("encoder_attention", 4.0 * B * Hq * hd * enc_len * n_attn,
                2.0 * n_attn * B * enc_len * Hkv * hd * el)
    elif n_attn or cfg.encoder_layers:
        io = lambda sq, skv: Bm * (2 * sq * Hq + 2 * skv * Hkv) * hd * el
        p_fwd = causal_pairs(S, S, causal=True, window=window)
        p_bwd = bwd_tile_pairs(S, S, causal=True, window=window)
        # decoder self-attention: forward kernel, recompute, backward
        f_layer = 4.0 * Bm * Hq * hd * p_fwd
        b_layer = io(S, S)
        f = n_attn * f_layer * fw
        by = n_attn * b_layer * fw
        if train:
            f += n_attn_g * f_layer + n_attn * 10.0 * Bm * Hq * hd * p_bwd
            by += n_attn_g * b_layer + n_attn * b_layer
        add("attention", calls * f, calls * by)
        if cfg.encoder_layers:
            # the encoder's self-attention and the decoder's
            # cross-attention to it, both non-causal
            fe = 4.0 * Bm * Hq * hd * enc_len * enc_len
            be = io(enc_len, enc_len)
            fx = 4.0 * Bm * Hq * hd * S * enc_len
            bx = io(S, enc_len)
            n_enc = cfg.encoder_layers
            f = (n_enc * fe + n_attn * fx) * fw
            by = (n_enc * be + n_attn * bx) * fw
            if train:
                pe = bwd_tile_pairs(enc_len, enc_len, causal=False, window=0)
                px = bwd_tile_pairs(S, enc_len, causal=False, window=0)
                f += (n_enc * fe + n_attn_g * fx
                      + 10.0 * Bm * Hq * hd * (n_enc * pe + n_attn * px))
                by += 2 * n_enc * be + (n_attn_g + n_attn) * bx
            add("encoder_attention", calls * f, calls * by)
        # prefill writes every attention layer's K and V into the cache
        if kind == "prefill":
            add("cache", 0.0, 2.0 * n_attn * B * S * Hkv * hd * el)

    # ---- the scans ------------------------------------------------------
    def layer_passes(kind_: str, bwd: float) -> float:
        """Forward passes of a scan over its layers: at train the
        forward, the recompute (grouped layers) and ``bwd`` more."""
        g, tl = n_grouped.get(kind_, 0), n_tail.get(kind_, 0)
        return (fw + bwd) * (g + tl) + g if train else float(g + tl)

    n_rec = n_grouped.get("rec", 0) + n_tail.get("rec", 0)
    n_ssd = n_grouped.get("ssd", 0) + n_tail.get("ssd", 0)
    if n_rec:
        w = cfg.rglru.lru_width or d
        # h = a h + b: a multiply and an add an element, fp32; the
        # backward's reverse scan about twice that
        f = 2.0 * T * w
        by = 0.0 if decode else T * w * 8   # u + gate read, y written
        add("rglru_scan", calls * f * layer_passes("rec", 2.0),
                  calls * by * (3 if train else 1) * n_rec)
    if n_ssd:
        s = cfg.ssm
        di, H, N = s.d_inner(d), s.n_heads(d), s.d_state
        Pd = s.head_dim
        if decode:
            f = 4.0 * B * H * Pd * N          # state update, state . C
            by = 0.0
        else:
            Q = min(s.chunk_size, S)
            f = 2.0 * Bm * S * H * (Q * (N + Pd) + 2 * N * Pd)
            by = T * di * 12.0
        # train: the backward is the plain version's vjp: its forward
        # once more and two products for each of its products
        add("ssd_scan", calls * f * layer_passes("ssd", 3.0),
                  calls * by * (3 if train else 1) * n_ssd)

    # ---- MoE dispatch I/O (the reference's grouped-matmul formula: each
    # routed token read and written once a layer) -------------------------
    if cfg.moe is not None and not decode:
        n_moe = cfg.num_layers
        add("moe_dispatch", 0.0,
                  calls * (3 if train else 1) * n_moe * T * cfg.moe.top_k
                  * d * el * 2)

    # ---- activations at block boundaries --------------------------------
    n_layers = len(kinds)
    act = 2.0 * T * d * el * n_layers + 2.0 * T_enc * d * el * \
        cfg.encoder_layers
    if train:
        n_enc = cfg.encoder_layers
        rem = 2.0 * T * d * el * sum(n_grouped.values()) + \
            2.0 * T_enc * d * el * n_enc
        add("activations", 0.0, calls * (act * fw + rem + 1.5 * act))
    else:
        add("activations", 0.0, act)

    # ---- decode state / AdamW / gradient accumulation -------------------
    if decode:
        # the recurrent states (RG-LRU, SSD, their conv windows) are read
        # and written whole
        _, cache, _ = decode_input_shapes(cfg, B, S, params)
        state = sum(_nbytes(t) for path, t in _paths(cache)
                    if path[0] != "enc_kv" and path[-1] not in
                    ("k", "v", "k_scale", "v_scale"))
        add("cache", 0.0, 2.0 * state)
    if train:
        n_bytes = _tree_bytes(params)
        n_params = sum(t.numel() for t in tree_leaves(params))
        g_bytes = (grad_acc_bytes * n_params if n_micro > 1
                   and micro_mode == "accum" else n_bytes)
        # global norm and update read the gradients; m, v and the fp32
        # masters are read and written; the new parameters written
        add("optimizer", 0.0, 2 * g_bytes + 24 * n_params + n_bytes)
        if n_micro > 1:
            if micro_mode == "accum":
                # each microbatch: read its gradients, read and write the
                # accumulator
                add("grad_accumulation", 0.0, n_micro * (
                    n_bytes + 2 * grad_acc_bytes * n_params))
            else:
                add("grad_accumulation", 0.0, n_micro * 2 * n_bytes)

    return {
        "flops": sum(c["flops"] for c in comps.values()),
        "bytes": sum(c["bytes"] for c in comps.values()),
        "collective_bytes": 0.0,
        "components": comps,
    }


def _stand_in_bytes(x) -> int:
    return math.prod(x.shape) * torch.empty((), dtype=x.dtype).element_size()


def _step_bytes(cfg, cell, params) -> Tuple[int, int]:
    """(argument bytes, output bytes) of the cell's step: parameters and
    the batch, with AdamW's fp32 state at train (returned updated), the
    logits and the cache at prefill and decode."""
    p = _tree_bytes(params)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        state = p + 12 * sum(t.numel() for t in tree_leaves(params))
        batch = sum(map(_stand_in_bytes, batch_shapes(cfg, B, S).values()))
        return state + batch, state
    logits = B * cfg.padded_vocab() * torch.empty(
        (), dtype=pdtype(cfg)).element_size()
    cache = _tree_bytes(decode_input_shapes(cfg, B, S, params)[1])
    if cell.kind == "prefill":
        batch = sum(_stand_in_bytes(x) for k, x in
                    batch_shapes(cfg, B, S).items() if k != "labels"
                    and k != "mask")
        return p + batch, logits + cache
    return p + cache + 4 * B, logits + cache


def record_of(arch: str, cell: ShapeCell, count: Dict, cfg,
              seconds: float, params) -> Dict:
    """A dry-run record in the reference's fields from one count."""
    flops, byts = count["flops"], count["bytes"]
    coll = count["collective_bytes"]
    terms = roofline_terms(flops, byts, coll)
    mf = model_flops(cfg, cell)          # one device: per device
    denom = max(terms.values()) or 1e-30
    arg_bytes, out_bytes = _step_bytes(cfg, cell, params)
    return {
        "arch": arch,
        "cell": cell.name,
        "mesh": MESH,
        "n_chips": 1,
        "status": "OK",
        "compile_s": round(seconds, 1),
        "bytes_per_device": None,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "flops_per_device": flops,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": byts,
        "collective_bytes_per_device": coll,
        "collectives": {},
        "raw_flops_per_device": flops,
        "raw_bytes_per_device": byts,
        **{k: round(v, 6) for k, v in terms.items()},
        "r_cloud_est": {k: round(v, 4) for k, v in
                        r_cloud_estimates(flops, byts, coll).items()},
        "dominant": dominant_term(terms),
        "model_flops_per_device": mf,
        "useful_flops_ratio": round(mf / flops, 4) if flops else None,
        "roofline_fraction": round(
            (mf / PEAK_FLOPS) / denom, 4) if denom else None,
        "components": count["components"],
    }


def analyze_cell(arch: str, cell, cfg_override=None, **count_kwargs):
    """The record of one cell (a name of SHAPE_CELLS or a ``ShapeCell``)
    on one device: the count of the port's step, its roofline terms on
    the H100, ``r_cloud_est`` for every hardware class, and the
    reference's ratios.  ``compile_s`` is the count's host time: there
    is nothing to compile."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    cell = cell_by_name(cell) if isinstance(cell, str) else cell
    t0 = time.time()
    params = param_shapes(cfg)
    count = count_cell(cfg, cell, params=params, **count_kwargs)
    return record_of(arch, cell, count, cfg, time.time() - t0, params)


def parse_batch_times(spec: str):
    """Parse ``--batch-times "1:0.016,2:0.0256,4:0.051"`` into
    ((batch_size, seconds), ...) pairs for ``BatchModel.from_timings``."""
    pairs = []
    for item in spec.split(","):
        b, _, t = item.partition(":")
        pairs.append((int(b), float(t)))
    if len(pairs) < 2:
        raise ValueError("--batch-times needs >= 2 points, e.g. "
                         "'1:0.016,2:0.0256'")
    return tuple(pairs)


def fit_batch_calibration(timings, batch_sizes=(2, 3, 4, 8)):
    """Fit the §4.4 batching micro-model from real multi-point batch
    timings (``cost_model.fit_batch_model``) and evaluate c_batch at the
    sizes serving cares about.  The result is what ``JobSpec`` /
    ``SimConfig.batch_timings`` consume — replacing the single pinned
    ``c_batch_at`` measurement with a calibrated slope."""
    from repro_torch.core.cost_model import BatchModel
    model = BatchModel.from_timings(timings)
    return {
        "t_startup": model.t_startup,
        "t_task": model.t_task,
        "c_batch": {str(b): model.c_batch(b) for b in batch_sizes},
        "timings": [list(x) for x in timings],
    }


def write_capacity(records, out_path: str, cell: Optional[str] = None,
                   count_per_class: int = 8) -> int:
    """Aggregate the per-hardware ``r_cloud_est`` maps of ``records``
    into a calibrated ``CloudCapacity`` artifact (JSON rows, one per GPU
    class) — the roofline-driven replacement for hand-calibrated
    per-class rates.  Returns the number of classes written."""
    from repro_torch.core.capacity import CloudCapacity
    ok = [r for r in records if r.get("r_cloud_est")]
    if not ok:
        return 0
    hw_names = sorted({hw for r in ok for hw in r["r_cloud_est"]})
    cap = CloudCapacity.from_roofline(
        ok, counts={hw: count_per_class for hw in hw_names}, cell=cell)
    with open(out_path, "w") as f:
        json.dump(cap.to_json(), f, indent=1)
    return len(cap)


def sweep(archs=None, cells=None, out=None):
    """Records of every (arch, cell), SKIP records included, in the
    reference's order; each line also written to the file ``out`` when
    one is open."""
    results = []
    for arch in archs or ARCH_IDS:
        cfg = get_config(arch)
        for cell_name in cells or [c.name for c in SHAPE_CELLS]:
            cell = cell_by_name(cell_name)
            ok, reason = cell_supported(cfg, cell)
            if not ok:
                rec = {"arch": arch, "cell": cell_name, "status": reason}
            else:
                try:
                    rec = analyze_cell(arch, cell)
                except Exception as e:  # a failure here is a bug
                    rec = {"arch": arch, "cell": cell_name, "mesh": MESH,
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    traceback.print_exc()
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default="dryrun.jsonl")
    ap.add_argument("--save-hlo", default=None,
                    help="not available: the port counts its step and "
                         "compiles no HLO")
    ap.add_argument("--capacity-out", default=None,
                    help="write the roofline-calibrated CloudCapacity "
                         "(per-hardware r_cloud classes) to this JSON file")
    ap.add_argument("--batch-times", default=None,
                    help="measured batch timings 'b:sec,b:sec,...' "
                         "(>= 2 points): fits the §4.4 batching "
                         "micro-model so c_batch comes from real data "
                         "instead of the pinned batch-2 extrapolation")
    ap.add_argument("--batch-model-out", default=None,
                    help="write the fitted batch model (t_startup, "
                         "t_task, c_batch table) to this JSON file")
    args = ap.parse_args(argv)

    if args.single_pod_only or args.multi_pod_only:
        raise NotImplementedError(
            "--single-pod-only / --multi-pod-only: the port counts one "
            "device; pod meshes are ROADMAP A10")
    if args.save_hlo:
        raise NotImplementedError(
            "--save-hlo: the port counts its own step and has no HLO to save")

    if args.batch_times:
        cal = fit_batch_calibration(parse_batch_times(args.batch_times))
        print("batch model fit: "
              f"t_startup={cal['t_startup']:.6g}s "
              f"t_task={cal['t_task']:.6g}s "
              f"c_batch(2)={cal['c_batch']['2']:.4g} "
              f"c_batch(4)={cal['c_batch']['4']:.4g}")
        if args.batch_model_out:
            with open(args.batch_model_out, "w") as f:
                json.dump(cal, f, indent=1)
            print(f"wrote batch model to {args.batch_model_out} "
                  "(feed timings to JobSpec/SimConfig.batch_timings)")
        if not (args.arch or args.cell or args.capacity_out):
            # pure calibration invocation: don't kick off the full
            # arch x cell sweep as a side effect
            return 0

    archs = [args.arch] if args.arch else ARCH_IDS
    cells = [args.cell] if args.cell else [c.name for c in SHAPE_CELLS]
    with open(args.out, "a") as f:
        records = sweep(archs, cells, f)
    for rec in records:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "components"}))
    results = [r for r in records if "SKIP" not in str(r.get("status"))]
    if args.capacity_out:
        n_classes = write_capacity(results, args.capacity_out,
                                   cell=args.cell)
        print(f"wrote {n_classes} calibrated GPU classes to "
              f"{args.capacity_out}")
    n_fail = sum("FAIL" in str(r.get("status")) for r in results)
    print(f"\n{len(results)} cells run, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
