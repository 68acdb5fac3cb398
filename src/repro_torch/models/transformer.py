"""Decoder-only LM: the shared block machinery and the full-sequence
forward of the LM zoo.

Counterpart of ``repro/models/transformer.py``.  The parameter tree is
the reference's: block parameters are stacked over "pattern groups"
(``cfg.block_pattern`` tiled), so every leaf under ``params["blocks"]``
has a leading dimension ``G = cfg.num_groups()``; the remainder layers
(``cfg.tail_pattern()``) sit unstacked under ``params["tail"]``.  A tree initialised in JAX converts
leaf for leaf (``repro_torch.convert.from_jax_params``).  The reference's
``lax.scan`` over groups is a Python loop over the stacked dimension
here; PyTorch runs eagerly, so there is nothing to compile.  Its
``jax.checkpoint`` of a group's body becomes ``torch.utils.checkpoint``
when grad is enabled.

``run_layer_range`` is the paper's segmentation hook: the cloud runs
groups ``[0, g)``, ships the hidden state, the device runs ``[g, G)``.

``prefill`` -> ``pad_kv_caches`` -> ``decode_step`` is autoregressive
decode.  Unlike the reference, whose ``_decode_attn`` only says in a
comment that its TPU path would use its decode kernel, every cache mode
here (linear, SWA ring, SWA over a longer linear cache) goes through
``kernels.ops.decode_attention``: the hand-written CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.  The cache is updated in
place (see ``models/attention.py``).

Encoder-decoder models (``cfg.encoder_layers``): ``encode`` runs the
encoder over the frontend's frames (non-causal self-attention), and each
decoder block attends to its output through a cross-attention branch.
On a CUDA tensor that branch runs the flash kernel at prefill
(``attention.cross_attention``) and the decode kernel against the
static ``cache["enc_kv"]`` at decode; the reference computes both with
its einsum attention.

Over a mesh of ``torch.distributed`` ranks (a ``ShardCtx`` whose model
axis is above 1), prefill and decode run the reference's dense tensor
parallelism, which it gets from GSPMD, written out: each rank holds its
blocks of a tree cut by ``distributed/sharding.py::param_specs``
(self-attention by heads, the dense MLP by ``d_ff``, the RG-LRU by
channels, the SSD by ``d_inner`` in whole heads, the vocabulary by rows
and columns), sums each block's partial outputs over the axis
(``collectives.psum``; the SSD's gated norm sums its squares so too),
keeps its own recurrent states, and gathers the logits whole.  An
encoder's blocks are cut as the decoder's self-attention blocks, and a
decoder block's cross-attention branch by heads as its self-attention;
the encoder's output stays whole on every rank.

Training under it (``train_forward`` over a model axis above 1) runs for
self-attention blocks, the dense MLP and the vocabulary: the sums'
backward is the identity, each whole tensor that enters a rank's part
of a cut product passes ``_replicated`` (its gradient summed over the
axis), and ``lm_loss`` takes the log-sum-exp over the ranks' vocabulary
columns.  Cut RG-LRU, SSD and encoder-decoder blocks and MoE layers
raise under autograd (``_refuse_autograd``).

Ported so far: attention (self- and cross-attention), RG-LRU and SSD
(Mamba-2) blocks, dense MLPs and Mixture-of-Experts FFNs
(``models/moe.py``, on one device and in its ``tp`` / ``ep`` modes over
a mesh of ranks), the encoder, decode over all of
them, the modality frontends of decoder-only models (a prefix of the
sequence), and training: ``lm_loss`` and ``train_forward``, with each
group's blocks recomputed in the backward pass.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
import torch.utils.checkpoint

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.convert import keystr, tree_leaves_with_path, tree_map
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import (
    apply_norm,
    apply_rope,
    dense_init,
    embed_init,
    init_norm,
    matmul_f32,
    pdtype,
)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import LOCAL_CTX, ShardCtx

Params = Dict[str, Any]


def _tree_stack(trees: List[Any]) -> Any:
    """Stack the leaves of same-shaped trees along a new leading dim.
    Leaves on the ``meta`` device (shapes only) get an empty stack: the
    first ``torch.stack`` of meta tensors in a process imports ~800
    modules (2-4 s), which a rank's first prefill would pay."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if first.is_meta:
        return first.new_empty((len(trees),) + tuple(first.shape))
    return torch.stack(trees)


def _tree_unbind(tree: Any, n: int) -> List[Any]:
    """The ``n`` slices of every leaf's leading dimension, as ``n`` trees
    of views.  Under autograd one ``unbind`` a leaf stacks the slices'
    gradients once, where ``n`` selects would each write a gradient of
    the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _tree_index(tree: Any, i: int) -> Any:
    """Slice ``i`` of every leaf's leading dimension (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# ==========================================================================
# Block init
# ==========================================================================
def init_attn_block(generator, cfg, cross: bool = False,
                    device: DeviceLike = None) -> Params:
    device = resolve_device(device)
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    dt = pdtype(cfg)
    p: Params = {
        "norm1": init_norm(cfg, d, device),
        "wq": dense_init(generator, (d, cfg.num_heads, hd), dt, fan_in=d,
                         device=device),
        "wk": dense_init(generator, (d, cfg.num_kv_heads, hd), dt, fan_in=d,
                         device=device),
        "wv": dense_init(generator, (d, cfg.num_kv_heads, hd), dt, fan_in=d,
                         device=device),
        "wo": dense_init(generator, (cfg.num_heads, hd, d), dt,
                         fan_in=cfg.num_heads * hd, device=device),
        "norm2": init_norm(cfg, d, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads, hd), device=device)
        p["bk"] = torch.zeros((cfg.num_kv_heads, hd), device=device)
        p["bv"] = torch.zeros((cfg.num_kv_heads, hd), device=device)
    if cross:
        p["xnorm"] = init_norm(cfg, d, device)
        p["xwq"] = dense_init(generator, (d, cfg.num_heads, hd), dt,
                              fan_in=d, device=device)
        p["xwk"] = dense_init(generator, (d, cfg.num_kv_heads, hd), dt,
                              fan_in=d, device=device)
        p["xwv"] = dense_init(generator, (d, cfg.num_kv_heads, hd), dt,
                              fan_in=d, device=device)
        p["xwo"] = dense_init(generator, (cfg.num_heads, hd, d), dt,
                              fan_in=cfg.num_heads * hd, device=device)
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(generator, cfg, device)
    else:
        p["mlp"] = init_mlp(generator, cfg, device=device)
    return p


def init_block(kind: str, generator, cfg, cross: bool = False,
               device: DeviceLike = None) -> Params:
    device = resolve_device(device)
    if kind == "attn":
        return init_attn_block(generator, cfg, cross=cross, device=device)
    if kind == "rec":
        return {
            "norm1": init_norm(cfg, cfg.d_model, device),
            "rglru": rglru_lib.init_rglru_block(generator, cfg, device),
            "norm2": init_norm(cfg, cfg.d_model, device),
            "mlp": init_mlp(generator, cfg, device=device),
        }
    if kind == "ssd":
        return {
            "norm1": init_norm(cfg, cfg.d_model, device),
            "ssd": ssd_lib.init_ssd_block(generator, cfg, device),
        }
    raise ValueError(kind)


def init_params(cfg, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` and placed on ``device``
    (``None`` = the GPU), in the reference's tree: group-stacked blocks,
    unstacked tail, padded-vocab embedding and head."""
    dev = resolve_device(device)
    G = cfg.num_groups()
    cross = cfg.encoder_layers > 0
    blocks = {
        f"b{i}": _tree_stack([init_block(kind, generator, cfg, cross=cross,
                                         device=dev)
                              for _ in range(G)])
        for i, kind in enumerate(cfg.block_pattern)
    }
    tail = {
        f"t{i}": init_block(kind, generator, cfg, cross=cross, device=dev)
        for i, kind in enumerate(cfg.tail_pattern())
    }
    params: Params = {
        "embed": embed_init(generator, (cfg.padded_vocab(), cfg.d_model),
                            pdtype(cfg), dev),
        "blocks": blocks,
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }
    if tail:
        params["tail"] = tail
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab()), pdtype(cfg),
            device=dev)
    if cfg.encoder_layers:
        params["encoder"] = init_encoder(generator, cfg, dev)
    if cfg.frontend is not None and cfg.frontend.embed_dim != cfg.d_model:
        params["frontend_proj"] = dense_init(
            generator, (cfg.frontend.embed_dim, cfg.d_model), pdtype(cfg),
            device=dev)
    return params


def init_encoder(generator, cfg, device: DeviceLike = None) -> Params:
    """``cfg.encoder_layers`` stacked self-attention blocks and the
    encoder's final norm, on ``device`` (``None`` = the GPU)."""
    dev = resolve_device(device)
    blocks = _tree_stack([init_attn_block(generator, cfg, cross=False,
                                          device=dev)
                          for _ in range(cfg.encoder_layers)])
    return {"blocks": blocks, "final_norm": init_norm(cfg, cfg.d_model, dev)}


# ==========================================================================
# Block apply — full-sequence mode (prefill)
# ==========================================================================
def _qkv(p, h, cfg, positions, ctx=None):
    q = torch.einsum("bsd,dhe->bshe", h, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", h, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _block_shapes(kind: str, cfg, cross: bool) -> Dict[str, tuple]:
    """{path: shape} of one block of ``kind`` as ``cfg`` lays it out
    (drawn on the ``meta`` device: no memory, no numbers)."""
    tree = init_block(kind, torch.Generator(), cfg, cross=cross,
                      device="meta")
    return {keystr(path): tuple(t.shape)
            for path, t in tree_leaves_with_path(tree)}


def _tp(ctx) -> bool:
    """Whether ``ctx`` has a model axis above 1."""
    return ctx is not None and ctx.mesh is not None and ctx.model_size > 1


def _need_model_axis(ctx) -> None:
    if not _tp(ctx):
        raise ValueError("a weight cut over a model axis needs that axis: "
                         "pass the mesh's ctx")


def _model_rank(ctx) -> int:
    """This rank's coordinate on ``ctx``'s model axis."""
    _need_model_axis(ctx)
    return ctx.mesh.axis_index(ctx.model_axis)


def _psum(y, ctx, dtype=None):
    """The ranks' partial ``y`` summed over the model axis
    (``collectives.psum``: fp32 in rank order), rounded once to ``dtype``
    (``y``'s by default).  A cut product's partial comes in fp32
    (``common.matmul_f32``), so that the sum rounds it once, as one
    device rounds its product.  Under autograd its backward is the
    identity."""
    _need_model_axis(ctx)
    return collectives.psum(y, ctx.model_axis, mesh=ctx.mesh).to(
        dtype or y.dtype)


def _replicated(x, ctx):
    """``x``, whole on every rank, where it enters this rank's part of a
    cut product (``collectives.replicated``): under autograd its gradient
    is summed over the model axis, since the rank's part gives only its
    share."""
    _need_model_axis(ctx)
    return collectives.replicated(x, ctx.model_axis, mesh=ctx.mesh)


def _block_needs_grad(p, x) -> bool:
    """Whether autograd records a block's computation on ``x``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *(leaf for _, leaf in
                                       tree_leaves_with_path(p))])


def _refuse_autograd(kind, p, x, cfg, ctx) -> None:
    """Under autograd over a model axis above 1, refuse the blocks whose
    backward is not ported, before any collective: RG-LRU and SSD blocks
    and an encoder-decoder's blocks (cross-attention and the encoder)
    cut by ``param_specs`` (ROADMAP A10.2c-train-rec), and a Mixture-of-
    Experts layer (ROADMAP A10.2b-moe)."""
    if not (_tp(ctx) and _block_needs_grad(p, x)):
        return
    if kind == "attn" and "moe" in p:
        raise NotImplementedError(
            "training a Mixture-of-Experts layer over a model axis of "
            f"{ctx.model_size} is ROADMAP A10.2b-moe")
    if (kind != "attn" or cfg.encoder_layers) and _cut_over_model(
            kind, p, cfg, ctx):
        what = ("an encoder-decoder's attention block" if kind == "attn"
                else f"a {kind} block")
        raise NotImplementedError(
            f"training {what} cut over a model axis of {ctx.model_size} "
            f"(the backward of its sums) is ROADMAP A10.2c-train-rec")


def _rank_block_shapes(kind: str, cfg, ctx,
                       encoder: bool = False) -> Dict[str, tuple]:
    """{path: shape} of one block of ``kind`` on a rank of ``ctx``'s mesh
    under ``param_specs`` (``sharding.local_shapes``, read off the first
    stacked block of that kind, or off the encoder's stack with
    ``encoder``; every block of a stack is cut alike)."""
    prefix = ("['encoder']['blocks']" if encoder else
              f"['blocks']['b{cfg.block_pattern.index(kind)}']")
    return {key[len(prefix):]: shape[1:] for key, shape in
            sharding.local_shapes(cfg, ctx.mesh, ctx.model_axis).items()
            if key.startswith(prefix)}


def _no_rank_alone(kind, cfg, M: int):
    """Why no rank can compute its ``param_specs`` blocks of a ``kind``
    block alone over a model axis of ``M``, or None where it can."""
    if kind == "rec":
        W, nb = cfg.rglru.lru_width or cfg.d_model, cfg.rglru.diag_blocks
        if W % M == 0 and nb % M:
            return (f"the LRU width {W} is cut by channel while the "
                    f"{nb} gate blocks (wa, wx) stay whole, so a rank's "
                    f"{W // M} channels cover only part of a gate block")
    if kind == "ssd":
        di, P, G = (cfg.ssm.d_inner(cfg.d_model), cfg.ssm.head_dim,
                    cfg.ssm.n_groups)
        if di % M == 0 and (di // M) % P:
            return (f"d_inner {di} is cut into {di // M} channels a rank, "
                    f"not a whole number of heads of {P}")
        if di % M == 0 and G > 1:
            return (f"n_groups {G}: a rank's heads would have to read "
                    f"their own B/C groups, which is not built")
    return None


def _cut_over_model(kind, p, cfg, ctx, lead: tuple = ()) -> bool:
    """Whether block ``p`` (or a stack of blocks, ``lead`` its leading
    dimensions) holds this rank's blocks of its weights under
    ``distributed/sharding.py::param_specs`` over ``ctx``'s model axis
    (dense tensor parallelism), or the config's whole shapes.  An
    attention block without cross-attention leaves in a model with an
    encoder is an encoder block, held to the encoder stack's shapes.  Its
    Mixture-of-Experts leaves are not looked at: ``moe.apply_moe`` checks
    them.  Without a model axis above 1 it is whole (prefill and decode
    hold the tree to that: ``_check_tree``).  Raises where the leaves are
    neither all whole nor all cut (a rank would compute wrong answers
    without a word), and where the rules cut an RG-LRU or SSD block so
    that no rank can compute alone (``_no_rank_alone``)."""
    if not _tp(ctx):
        return False
    cross = "xwq" in p
    encoder = kind == "attn" and bool(cfg.encoder_layers) and not cross
    leaves = [(keystr(path), tuple(t.shape))
              for path, t in tree_leaves_with_path(p)
              if not keystr(path).startswith("['moe']")]

    def fits(want):
        return all(key in want and shape == lead + want[key]
                   for key, shape in leaves)
    whole = _block_shapes(kind, cfg, cross)
    if fits(whole):
        return False
    mine = _rank_block_shapes(kind, cfg, ctx, encoder)
    if fits(mine):
        why = _no_rank_alone(kind, cfg, ctx.model_size)
        if why:
            raise NotImplementedError(
                f"{kind} block cut by param_specs over a model axis of "
                f"{ctx.model_size}: {why}; no rank can compute its blocks "
                f"alone under dense tensor parallelism (ROADMAP A10.2c); "
                f"give such blocks whole")
        return True
    cut = [f"{key} {shape}" for key, shape in leaves
           if shape != lead + whole.get(key, ())]
    kept = [key for key, shape in leaves if key in whole
            and shape == lead + whole[key] != lead + mine.get(key, ())]
    raise NotImplementedError(
        f"{'encoder ' if encoder else ''}{kind} block over a model axis of "
        f"{ctx.model_size}: {', '.join(cut)} not the config's whole shapes"
        f"{' while ' + ', '.join(kept) + ' are' if kept else ''}, and the "
        f"block not this rank's blocks either: dense tensor parallelism "
        f"takes every leaf of a block whole or every leaf cut by "
        f"distributed/sharding.py::param_specs (ROADMAP A10.2c)")


def _check_tree(params, cfg, ctx) -> None:
    """The one check of the tree a prefill or decode call computes on,
    made before any of it runs (so every rank raises before a
    collective).  Each block of ``params`` (the stacked groups, the tail,
    an encoder's stack) is walked once, stacked.

    Without a model axis above 1 every block, its Mixture-of-Experts
    layer included, must hold the config's whole shapes (ROADMAP C2: a
    rank's cut block would give wrong answers without a word).  Over one,
    each stack of blocks, the encoder's too, is whole or this rank's
    ``param_specs`` blocks (``_cut_over_model``), each independently of
    the others; ``embed`` and ``lm_head`` are whole or cut by vocabulary
    rows and columns."""
    G = cfg.num_groups()
    stacks = [(kind, params["blocks"][f"b{i}"], (G,))
              for i, kind in enumerate(cfg.block_pattern)]
    stacks += [(kind, params["tail"][f"t{i}"], ())
               for i, kind in enumerate(cfg.tail_pattern())]
    encoder = ([("attn", params["encoder"]["blocks"], (cfg.encoder_layers,))]
               if cfg.encoder_layers else [])
    if not _tp(ctx):
        for kind, p, lead in stacks + encoder:
            want = _block_shapes(kind, cfg, "xwq" in p)
            for path, t in tree_leaves_with_path(p):
                key = keystr(path)
                whole = want.get(key)
                if whole is None or tuple(t.shape) != lead + whole:
                    raise NotImplementedError(
                        f"{kind} block leaf {key} of shape {tuple(t.shape)}"
                        f", not the config's "
                        f"{lead + whole if whole else None}: without a "
                        f"model axis above 1 every block computes with "
                        f"whole weights, and a block cut over one needs "
                        f"dense tensor parallelism (ROADMAP A10.2c)")
        return
    for kind, p, lead in stacks + encoder:
        _cut_over_model(kind, p, cfg, ctx, lead)
    local = sharding.local_shapes(cfg, ctx.mesh, ctx.model_axis)
    Vp, d = cfg.padded_vocab(), cfg.d_model
    for key, whole in (("embed", (Vp, d)), ("lm_head", (d, Vp))):
        mine = local.get(f"[{key!r}]")
        if key in params and tuple(params[key].shape) not in (whole, mine):
            raise NotImplementedError(
                f"{key} of shape {tuple(params[key].shape)}: over a model "
                f"axis of {ctx.model_size} it is whole {whole} or this "
                f"rank's vocabulary block {mine} (ROADMAP A10.2c)")


def _rank_kv(p, k, v, cfg, ctx):
    """The kv heads this rank's query heads read: ``k`` and ``v`` as they
    are, unless only the query heads are cut (the kv heads do not divide
    the model axis, so every rank holds them all); then the ones its
    global query heads pair with (``attention.kv_heads_for``), not what a
    kernel's own pairing of local heads would pick."""
    n_q = p["wq"].shape[-2]
    if n_q == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k, v
    return attn_lib.kv_heads_for(k, v, _model_rank(ctx) * n_q, n_q,
                                 cfg.num_heads // cfg.num_kv_heads)


def _heads_out(o, wo, cfg, ctx):
    """The attention output ``o`` through ``wo``: when ``wo`` is cut, an
    fp32 partial over this rank's heads, summed over the model axis."""
    if wo.shape[0] == cfg.num_heads:
        return torch.einsum("bshe,hed->bsd", o, wo)
    return _psum(matmul_f32(o.flatten(-2), wo.flatten(0, 1)), ctx, o.dtype)


def _mlp(p, x, cfg, ctx):
    """The dense MLP: when it is cut, an fp32 partial over this rank's
    ``d_ff`` columns of ``x`` (``_replicated``), summed over the model
    axis."""
    if p["wo"].shape[0] == cfg.d_ff:
        return apply_mlp(p, x, cfg)
    return _psum(apply_mlp(p, _replicated(x, ctx), cfg, out_f32=True), ctx,
                 x.dtype)


def _cut_attention_inputs(p, h, cfg, ctx):
    """The block ``p`` and the normed input ``h`` as a cut self-attention
    block's products take them: ``h`` through ``_replicated`` where the
    query heads are cut, and with them, where the kv heads are not (every
    rank holds all of them and reads only the ones its query heads pair
    with, ``_rank_kv``), ``wk``, ``wv`` and their biases: each rank's
    gradient of those whole leaves is its heads' share, summed over the
    model axis so that every rank holds the whole leaf's gradient."""
    if p["wq"].shape[-2] == cfg.num_heads:
        return p, h
    if p["wk"].shape[-2] == cfg.num_kv_heads:
        p = {**p, **{k: _replicated(p[k], ctx)
                     for k in ("wk", "wv", "bk", "bv") if k in p}}
    return p, _replicated(h, ctx)


def apply_attn_block_seq(p, x, cfg, ctx, *, positions, causal=True,
                         enc_out=None, return_kv=False):
    """Full-sequence attention block.  Returns (x, aux, kv | None).  A
    block with cross-attention weights attends to ``enc_out`` when it is
    given (no RoPE on that branch), and skips the branch when not.

    Over a model axis above 1, ``p`` may hold this rank's blocks under
    ``param_specs`` (``_cut_over_model``), the reference's dense tensor
    parallelism: its query heads (its kv heads too, where they divide the
    axis) and its ``d_ff`` columns.  Then attention and the MLP each end
    in one sum of their partial outputs over the model axis, ``x`` stays
    whole on every rank between blocks (the reference's
    ``_hidden_replicated``), and ``kv`` holds the rank's kv heads.  The
    cross-attention branch is cut alike: the rank's query heads of the
    whole ``x``, its kv heads of the whole ``enc_out`` (or the ones its
    query heads read, ``_rank_kv``), one sum of ``xwo``'s partial.  Where
    the heads do not divide the axis, attention and cross-attention are
    whole on every rank, with no sum; the reference cuts its queries by
    sequence there instead (``_attn_sharded``), for the same values
    (ROADMAP C).

    Under autograd a cut block's backward sums over the model axis the
    gradients of what enters its cut products whole
    (``_cut_attention_inputs``, the MLP's input in ``_mlp``); a cut
    cross-attention block or encoder block, and a Mixture-of-Experts
    layer over a model axis, raise first (``_refuse_autograd``)."""
    _cut_over_model("attn", p, cfg, ctx)
    _refuse_autograd("attn", p, x, cfg, ctx)
    h = apply_norm(p["norm1"], x)
    p, h = _cut_attention_inputs(p, h, cfg, ctx)
    q, k, v = _qkv(p, h, cfg, positions, ctx)
    window = cfg.window if cfg.attention_kind == "swa" else 0
    # positions here are always arange(S)
    o = attn_lib.self_attention(q, *_rank_kv(p, k, v, cfg, ctx),
                                causal=causal, window=window)
    x = x + _heads_out(o, p["wo"], cfg, ctx)
    if "xwq" in p and enc_out is not None:
        hx = apply_norm(p["xnorm"], x)
        xq = torch.einsum("bsd,dhe->bshe", hx, p["xwq"])
        xk = torch.einsum("bsd,dhe->bshe", enc_out, p["xwk"])
        xv = torch.einsum("bsd,dhe->bshe", enc_out, p["xwv"])
        xo = attn_lib.cross_attention(xq, *_rank_kv(p, xk, xv, cfg, ctx),
                                      q_positions=positions)
        x = x + _heads_out(xo, p["xwo"], cfg, ctx)
    h2 = apply_norm(p["norm2"], x)
    aux = None
    if "moe" in p:
        y, aux = moe_lib.apply_moe(p["moe"], h2, cfg, ctx)
    else:
        y = _mlp(p["mlp"], h2, cfg, ctx)
    x = x + y
    kv = {"k": k, "v": v} if return_kv else None
    return x, aux, kv


def _recurrent_block(kind, p, x, cfg, ctx, state=None, kernel_fn=None):
    """An RG-LRU (``rec``, with its MLP) or SSD block over ``x``, from
    ``state`` when given.  Returns (x, new_state).

    Over a model axis above 1, ``p`` may hold this rank's ``param_specs``
    blocks (``_cut_over_model``): the RG-LRU's channels (its gate blocks
    with them) and the MLP's ``d_ff``, or the SSD's ``d_inner`` by whole
    heads, with its B, C and dt whole.  The block then runs on them, its
    state is the rank's, and ``w_out``, the MLP and ``out_proj`` each end
    in one sum of their partial outputs over the axis, as does the SSD's
    gated norm's sum of squares; ``x`` stays whole on every rank."""
    h = apply_norm(p["norm1"], x)
    if kind == "rec":
        r = p["rglru"]
        cut = r["w_out"].shape[0] < (cfg.rglru.lru_width or cfg.d_model)
        y, new_state = rglru_lib.apply_rglru_block(
            r, h, cfg, state=state, kernel_fn=kernel_fn, out_f32=cut)
        x = x + (_psum(y, ctx, x.dtype) if cut else y)
        h2 = apply_norm(p["norm2"], x)
        return x + _mlp(p["mlp"], h2, cfg, ctx), new_state
    if kind == "ssd":
        s = p["ssd"]
        di_r = s["x_proj"].shape[-1]
        cut = di_r < cfg.ssm.d_inner(cfg.d_model)
        rank = (dict(first_head=_model_rank(ctx) * (di_r // cfg.ssm.head_dim),
                     norm_sum=lambda t: _psum(t, ctx), out_f32=True)
                if cut else {})
        y, new_state = ssd_lib.apply_ssd_block(
            s, h, cfg, state=state, kernel_fn=kernel_fn, **rank)
        return x + (_psum(y, ctx, x.dtype) if cut else y), new_state
    raise ValueError(kind)


def apply_block_seq(kind, p, x, cfg, ctx, *, positions, state=None,
                    enc_out=None, return_cache=False, kernels=None):
    """Returns (x, aux, cache_out).  cache_out depends on kind."""
    kernels = kernels or {}
    if kind == "attn":
        return apply_attn_block_seq(
            p, x, cfg, ctx, positions=positions, enc_out=enc_out,
            return_kv=return_cache)
    if kind not in ("rec", "ssd"):
        raise ValueError(kind)
    _cut_over_model(kind, p, cfg, ctx)
    _refuse_autograd(kind, p, x, cfg, ctx)
    x, new_state = _recurrent_block(
        kind, p, x, cfg, ctx, state,
        kernels.get("rglru" if kind == "rec" else "ssd"))
    return x, None, (new_state if return_cache else None)


# ==========================================================================
# Embedding / unembedding
# ==========================================================================
def embed_tokens(params, tokens, cfg, ctx: ShardCtx = LOCAL_CTX):
    """The embedding rows of ``tokens``.  An ``embed`` cut by vocabulary
    rows over ``ctx``'s model axis looks up only the tokens in this
    rank's rows, writes zeros for the rest, and sums over the axis: one
    rank holds each token's row, so the sum is exact."""
    table, tokens = params["embed"], tokens.long()
    rows = table.shape[0]
    if rows == cfg.padded_vocab():
        return table[tokens]
    local = tokens - _model_rank(ctx) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0)
    return _psum(x, ctx)


def _frontend_proj(params, frames):
    """Frames through ``frontend_proj`` when the tree has it.  The
    reference's einsum promotes fp32 frames against bf16 weights;
    torch.einsum takes one dtype, so promote here."""
    if "frontend_proj" not in params:
        return frames
    w = params["frontend_proj"]
    dt = torch.promote_types(frames.dtype, w.dtype)
    return torch.einsum("bpe,ed->bpd", frames.to(dt), w.to(dt))


def embed_inputs(params, batch, cfg, ctx: ShardCtx = LOCAL_CTX):
    """batch: {"tokens": (B,S)} (+ {"frontend": (B,P,E)} for vlm/audio).

    Frontend embeddings are prepended (they come from the STUB modality
    tower), through ``frontend_proj`` when the tree has it and cast to
    the embedding's dtype; total sequence = P + S_text."""
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.frontend is not None and "frontend" in batch:
        fe = _frontend_proj(params, batch["frontend"])
        x = torch.cat([fe.to(x.dtype), x], dim=1)
    return x


def unembed(params, h, cfg, ctx: ShardCtx = LOCAL_CTX):
    """Logits of the hidden states ``h``: this rank's block of vocabulary
    columns when ``lm_head`` (or the tied ``embed``) is cut over ``ctx``'s
    model axis (``gather_vocab`` puts the blocks together).  Padded
    columns, counted by their global index, are set to -1e30."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", h, w)
    Vp, cols = cfg.padded_vocab(), w.shape[1]
    if Vp != cfg.vocab_size:   # padded columns can never be sampled
        first = _model_rank(ctx) * cols if cols < Vp else 0
        keep = (torch.arange(first, first + cols, device=logits.device)
                < cfg.vocab_size)
        logits = torch.where(keep, logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=logits.device))
    return logits


def gather_vocab(logits, cfg, ctx: ShardCtx = LOCAL_CTX):
    """The whole (..., V) logits from every model rank's block of columns
    (``collectives.ring_all_gather``), as the reference returns them;
    whole logits pass as they are."""
    if logits.shape[-1] == cfg.padded_vocab():
        return logits
    whole = collectives.ring_all_gather(
        logits.movedim(-1, 0).contiguous(), ctx.model_axis, mesh=ctx.mesh)
    return whole.movedim(0, -1).contiguous()


# ==========================================================================
# Full-sequence forward (prefill)
# ==========================================================================
def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept: the counterpart of ``jax.checkpoint`` with the
    ``nothing_saveable`` policy."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _scan_groups(params, x, cfg, ctx, *, positions, enc_out=None,
                 return_cache=False, remat=True, kernels=None):
    """Run all pattern groups + tail.  Returns (x, aux_sum, caches).
    With ``remat`` and grad enabled each group's blocks keep only their
    input for the backward pass and run again there (the tail does not,
    as in the reference); without grad nothing is kept anyway."""
    pattern = cfg.block_pattern

    def group_body(gp, x, aux):
        caches = {}
        for i, kind in enumerate(pattern):
            x, a, c = apply_block_seq(
                kind, gp[f"b{i}"], x, cfg, ctx, positions=positions,
                enc_out=enc_out, return_cache=return_cache, kernels=kernels)
            if a is not None:
                aux = aux + torch.stack([a["load_balance"], a["router_z"]])
            caches[f"b{i}"] = c
        return x, aux, caches

    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((2,), device=x.device)   # load_balance, router_z
    group_caches = []
    for gp in _tree_unbind(params["blocks"], cfg.num_groups()):
        if remat:
            x, aux, caches = _remat(group_body, gp, x, aux)
        else:
            x, aux, caches = group_body(gp, x, aux)
        group_caches.append(caches)

    tail_caches = {}
    for i, kind in enumerate(cfg.tail_pattern()):
        x, a, c = apply_block_seq(
            kind, params["tail"][f"t{i}"], x, cfg, ctx, positions=positions,
            enc_out=enc_out, return_cache=return_cache, kernels=kernels)
        if a is not None:
            aux = aux + torch.stack([a["load_balance"], a["router_z"]])
        tail_caches[f"t{i}"] = c
    caches = None
    if return_cache:
        groups = _tree_stack(group_caches) if group_caches else {}
        caches = {"groups": groups, "tail": tail_caches}
    return x, aux, caches


def encode(params, frames, cfg, ctx):
    """Encoder stack over frontend frames (B, S_enc, d): non-causal
    self-attention blocks at positions ``arange(S_enc)``, then the
    encoder's final norm.  With grad enabled each block runs again in the
    backward pass, as the reference's checkpointed body does."""
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(bp, x):
        return apply_attn_block_seq(bp, x, cfg, ctx, positions=positions,
                                    causal=False)[0]

    x = frames
    for bp in _tree_unbind(enc["blocks"], cfg.encoder_layers):
        x = _remat(body, bp, x) if torch.is_grad_enabled() else body(bp, x)
    return apply_norm(enc["final_norm"], x)


def forward_hidden(params, batch, cfg, ctx: ShardCtx = LOCAL_CTX, *,
                   return_cache=False, remat=True, kernels=None):
    """Embed + all blocks + final norm.  Returns (hidden (B,S,d), aux (2,),
    caches).  An encoder-decoder model encodes ``batch["frontend"]``
    first, and its decoder blocks attend to the encoder's output, which
    ``caches["enc_out"]`` carries under ``return_cache``."""
    enc_out = None
    if cfg.encoder_layers:
        frames = _frontend_proj(params, batch["frontend"])
        enc_out = encode(params, frames.to(pdtype(cfg)), cfg, ctx)
        x = embed_tokens(params, batch["tokens"], cfg, ctx)
    else:
        x = embed_inputs(params, batch, cfg, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, caches = _scan_groups(
        params, x, cfg, ctx, positions=positions, enc_out=enc_out,
        return_cache=return_cache, remat=remat, kernels=kernels)
    x = apply_norm(params["final_norm"], x)
    if return_cache and enc_out is not None:
        caches["enc_out"] = enc_out
    return x, aux, caches


# ==========================================================================
# Loss: sequence-chunked cross entropy
# ==========================================================================
def _lse_and_target(logits, t_c, first: int, ctx):
    """The log-sum-exp of each row of the whole vocabulary and the
    target's logit, from this rank's columns ``[first, first + cols)``
    of it: the row max taken over the model axis (detached: the lse does
    not depend on it), then one sum over the axis of each rank's sum of
    exponentials and of its target logit (the rank whose columns hold
    the target gives it, the others zero).  A rank whose columns are all
    padding has a row max of -1e30 and adds zeros."""
    cols = logits.shape[-1]
    local_max = logits.detach().amax(dim=-1)
    top = collectives.ring_all_gather(
        local_max[None].contiguous(), ctx.model_axis,
        mesh=ctx.mesh).amax(dim=0)
    local = t_c.long() - first
    mine = (local >= 0) & (local < cols)
    tgt = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    sums = _psum(torch.stack([
        torch.exp(logits - top[..., None]).sum(dim=-1),
        torch.where(mine, tgt, torch.zeros((), device=tgt.device))]), ctx)
    return top + torch.log(sums[0]), sums[1]


def lm_loss(params, hidden, targets, mask, cfg, *, ctx: ShardCtx = LOCAL_CTX,
            chunk: int = 512, z_weight: float = 1e-4):
    """hidden (B,S,d) -> scalar mean NLL (+ z-loss).  Never builds (B,S,V):
    the logits of one chunk of ``chunk`` positions at a time, recomputed
    in the backward pass; the padded vocabulary is masked out of the
    log-sum-exp.

    With ``lm_head`` (or the tied ``embed``) cut by vocabulary columns
    over ``ctx``'s model axis, each rank computes its own columns' logits
    of the whole ``hidden`` (``_replicated``), masks the padded ones by
    their global index, and the log-sum-exp and the target's logit come
    from sums over the axis (``_lse_and_target``): every rank holds the
    same loss.  A cut vocabulary without a model axis in ``ctx`` raises
    ``ValueError``."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    Sc = n * chunk
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    Vp, cols = cfg.padded_vocab(), w.shape[1]
    cut = cols != Vp
    first = _model_rank(ctx) * cols if cut else 0

    def chunk_loss(h_c, t_c, m_c):
        if cut:
            h_c = _replicated(h_c, ctx)
        logits = torch.einsum("bsd,dv->bsv", h_c, w).float()
        if Vp != cfg.vocab_size:   # mask padded vocab columns out of the lse
            keep = (torch.arange(first, first + cols, device=logits.device)
                    < cfg.vocab_size)
            logits = torch.where(keep, logits,
                                 torch.full((), -1e30, device=logits.device))
        if cut:
            lse, tgt = _lse_and_target(logits, t_c, first, ctx)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, t_c.long()[..., None])[..., 0]
        nll = (lse - tgt) * m_c
        zl = lse.square() * m_c
        return nll.sum() + z_weight * zl.sum()

    def one(h_c, t_c, m_c):
        m_c = m_c.float()
        if torch.is_grad_enabled():
            return _remat(chunk_loss, h_c, t_c, m_c)
        return chunk_loss(h_c, t_c, m_c)

    total = torch.zeros((), device=hidden.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + one(hidden[:, sl], targets[:, sl], mask[:, sl])
    if Sc < S:
        total = total + one(hidden[:, Sc:], targets[:, Sc:], mask[:, Sc:])
    denom = torch.clamp_min(mask.float().sum(), 1.0)
    return total / denom


def train_forward(params, batch, cfg, ctx: ShardCtx = LOCAL_CTX, *,
                  kernels=None):
    """batch: tokens (B,S), labels (B,S), mask (B,S) [+ frontend].

    Returns (loss, metrics dict of 0-d tensors); a Mixture-of-Experts
    model's loss carries its router's load-balance and z terms."""
    hidden, aux, _ = forward_hidden(params, batch, cfg, ctx, kernels=kernels)
    loss = lm_loss(params, hidden, batch["labels"], batch["mask"], cfg,
                   ctx=ctx)
    metrics = {"nll": loss}
    if cfg.moe is not None:
        lb, rz = aux[0], aux[1]
        n_moe = cfg.num_layers
        loss = loss + (cfg.moe.router_aux_weight * lb
                       + cfg.moe.router_z_weight * rz) / n_moe
        metrics.update({"load_balance": lb / n_moe, "router_z": rz / n_moe})
    metrics["loss"] = loss
    return loss, metrics


# ==========================================================================
# Decode: caches & single-token step
# ==========================================================================
def init_decode_cache(cfg, batch: int, max_len: int,
                      device: DeviceLike = None):
    """Zero cache tree aligned with the group structure, on ``device``
    (``None`` = the GPU).  Each group's cache is its own memory (the
    reference broadcasts one zero cache; the port writes in place)."""
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim()
    kv_len = cfg.effective_kv_len(max_len)

    def one(kind):
        if kind == "attn":
            return attn_lib.init_kv_cache(
                batch, kv_len, cfg.num_kv_heads, hd, pdtype(cfg),
                quantized=cfg.kv_cache_dtype == "int8", device=dev)
        if kind == "rec":
            return rglru_lib.init_rglru_state(batch, cfg, dev)
        if kind == "ssd":
            return ssd_lib.init_ssd_state(batch, cfg, dev)
        raise ValueError(kind)

    G = cfg.num_groups()
    groups = {
        f"b{i}": tree_map(lambda a: a.new_zeros((G,) + tuple(a.shape)),
                          one(kind))
        for i, kind in enumerate(cfg.block_pattern)
    }
    tail = {f"t{i}": one(kind) for i, kind in enumerate(cfg.tail_pattern())}
    return {"groups": groups, "tail": tail}


def prefill(params, batch, cfg, ctx: ShardCtx = LOCAL_CTX, *, kernels=None,
            pad_to: int = 0):
    """Full-sequence prefill.  Returns (last-token logits, decode cache).
    Like the reference's, the attention caches are the prompt's k and v
    in the compute dtype, whatever ``cfg.kv_cache_dtype`` says.  An
    encoder-decoder model's cache also holds ``enc_kv``, the decoder
    layers' cross-attention K/V, which decode reads and never grows;
    like the reference, it projects them again from the encoder's output
    after the blocks have done so.

    Over a model axis above 1, ``params`` may be this rank's blocks under
    ``param_specs`` (attention with or without cross-attention, an
    encoder, RG-LRU and SSD blocks; ``_check_tree``) and ``batch`` its
    rows of the batch (of the tokens and of the frames); the logits are
    then gathered whole on every rank, and the cache holds the rank's kv
    heads, ``enc_kv``'s too (all of them where they do not divide the
    axis: the reference cuts its cache by sequence there, for the same
    values), its RG-LRU channels and its SSD heads, an SSD's ``conv`` as
    [its x channels | B | C] where ``cache_specs`` would cut the whole [x
    | B | C] into equal columns (ROADMAP C)."""
    _check_tree(params, cfg, ctx)
    hidden, _, caches = forward_hidden(
        params, batch, cfg, ctx, return_cache=True, remat=False,
        kernels=kernels)
    logits = gather_vocab(unembed(params, hidden[:, -1:], cfg, ctx), cfg,
                          ctx)
    if cfg.encoder_layers:
        caches["enc_kv"] = build_enc_kv(params, caches.pop("enc_out"), cfg)
    if pad_to:
        caches = pad_kv_caches(caches, pad_to)
    return logits, caches


def pad_kv_caches(caches, pad_to: int):
    """Grow attention KV caches (seq axis) with zeros so decode can append
    tokens.  Attention caches are dicts with exactly {"k", "v"}; the seq
    axis is ndim - 3 (stacked (G,B,S,H,D) and unstacked (B,S,H,D))."""
    def fix(node):
        if isinstance(node, dict) and set(node) == {"k", "v"}:
            out = {}
            for key, a in node.items():
                ax = a.dim() - 3
                if pad_to > a.shape[ax]:
                    shape = list(a.shape)
                    shape[ax] = pad_to
                    grown = a.new_zeros(shape)
                    grown.narrow(ax, 0, a.shape[ax]).copy_(a)
                    a = grown
                out[key] = a
            return out
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return {k: (fix(v) if k != "enc_kv" else v) for k, v in caches.items()}


def _decode_attn(p, x, cfg, ctx, cache, position: int, enc_kv=None):
    """One-token attention block.  x (B,1,d); ``cache`` is updated in
    place and returned.  The reference's position masks become the rows
    [lo, lo + n) of the cache every sequence attends to.  ``enc_kv``
    ({"k", "v"}, (B, S_enc, Hkv, D) views) feeds the cross-attention
    branch: every sequence attends to all S_enc rows.  Over a model axis,
    a cut block attends with the rank's heads (``_rank_kv``'s kv heads of
    the rank's ``enc_kv``) and sums ``wo``'s and ``xwo``'s partials."""
    h = apply_norm(p["norm1"], x)
    pos1 = torch.full((1,), position, device=x.device)
    q, k, v = _qkv(p, h, cfg, pos1)
    W = cfg.window if cfg.attention_kind == "swa" else 0
    if W and cache["k"].shape[1] == W:
        # ring: every written slot, min(position + 1, W) of them in slots
        # [0, n); softmax does not care for their order
        cache = attn_lib.cache_update_ring(cache, k, v, position)
        lo, n = 0, min(position + 1, W)
    else:
        # linear: keys [0, position], or the window (position - W,
        # position] inside a longer cache
        cache = attn_lib.cache_update_linear(cache, k, v, position)
        lo = max(0, position - W + 1) if W else 0
        n = position + 1 - lo
    ck, cv = attn_lib.dequantize_cache(cache)
    ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    if lo:               # a window inside a longer linear cache: a view
        ck, cv = ck[:, lo:lo + n], cv[:, lo:lo + n]
    lengths = torch.full((x.shape[0],), n, dtype=torch.int32,
                         device=x.device)
    o = ops.decode_attention(q, *_rank_kv(p, ck, cv, cfg, ctx), lengths)
    x = x + _heads_out(o, p["wo"], cfg, ctx)
    if "xwq" in p and enc_kv is not None:
        hx = apply_norm(p["xnorm"], x)
        xq = torch.einsum("bsd,dhe->bshe", hx, p["xwq"])
        enc_len = torch.full((x.shape[0],), enc_kv["k"].shape[1],
                             dtype=torch.int32, device=x.device)
        xo = ops.decode_attention(
            xq, *_rank_kv(p, enc_kv["k"], enc_kv["v"], cfg, ctx), enc_len)
        x = x + _heads_out(xo, p["xwo"], cfg, ctx)
    h2 = apply_norm(p["norm2"], x)
    if "moe" in p:
        y, _ = moe_lib.apply_moe(p["moe"], h2, cfg, ctx)
    else:
        y = _mlp(p["mlp"], h2, cfg, ctx)
    return x + y, cache


def _copy_state(cache, new_state):
    """Write a block's new recurrent state into its cache, in place."""
    for key, t in new_state.items():
        cache[key].copy_(t)
    return cache


def _decode_block(kind, p, x, cfg, ctx, cache, position: int, enc_kv=None):
    if kind == "attn":
        return _decode_attn(p, x, cfg, ctx, cache, position, enc_kv)
    x, new_state = _recurrent_block(kind, p, x, cfg, ctx, state=cache)
    return x, _copy_state(cache, new_state)


def _check_states(params, cache, cfg) -> None:
    """Each RG-LRU and SSD block's decode state against its weights (this
    rank's channels or heads where they are cut), before anything runs:
    a state of another layout raises here, not inside a split."""
    blocks = [(kind, params["blocks"][f"b{i}"], cache["groups"][f"b{i}"])
              for i, kind in enumerate(cfg.block_pattern)
              if cfg.num_groups()]
    blocks += [(kind, params["tail"][f"t{i}"], cache["tail"][f"t{i}"])
               for i, kind in enumerate(cfg.tail_pattern())]
    for kind, p, c in blocks:
        if kind == "rec":
            w = p["rglru"]["w_rec_in"].shape[-1]
            want = {"h": (w,), "conv": (cfg.rglru.d_conv - 1, w)}
        elif kind == "ssd":
            s, P, N = p["ssd"], cfg.ssm.head_dim, cfg.ssm.d_state
            di_r, gn = s["x_proj"].shape[-1], s["b_proj"].shape[-1]
            want = {"ssm": (di_r // P, P, N),
                    "conv": (cfg.ssm.d_conv - 1, di_r + 2 * gn)}
        else:
            continue
        for key, tail in want.items():
            got = tuple(c[key].shape)
            if got[-len(tail):] != tail:
                raise ValueError(
                    f"{kind} decode state {key!r} of shape {got}, not "
                    f"(..., {', '.join(map(str, tail))}) as its weights "
                    f"give it" + (
                        f": a rank's SSD conv state is [its {di_r} x "
                        f"channels | B | C ({2 * gn})], as prefill returns "
                        f"it, not a cache_specs block of the whole [x | B "
                        f"| C] cut into equal columns (ROADMAP C)"
                        if kind == "ssd" and key == "conv" else ""))


def build_enc_kv(params, enc_out, cfg):
    """Per-decoder-layer cross-attention K/V from the encoder's output:
    {"groups": {"b<i>": {"k", "v"} of (G, B, S_enc, Hkv, D)}, "tail":
    {"t<i>": {"k", "v"} of (B, S_enc, Hkv, D)}}.  Each group's K/V is a
    contiguous slice, so ``_tree_index`` hands decode views, not
    copies.  A rank's blocks cut by ``param_specs`` give its kv heads
    (all of them where ``xwk`` is whole)."""
    def one(bp):
        return {"k": torch.einsum("bsd,dhe->bshe", enc_out, bp["xwk"]),
                "v": torch.einsum("bsd,dhe->bshe", enc_out, bp["xwv"])}

    groups = {
        name: _tree_stack([one(_tree_index(stack, g))
                           for g in range(cfg.num_groups())])
        for name, stack in params["blocks"].items()
    }
    tail = {name: one(bp) for name, bp in params.get("tail", {}).items()}
    return {"groups": groups, "tail": tail}


def decode_step(params, token, cache, position, cfg,
                ctx: ShardCtx = LOCAL_CTX):
    """token (B,1) int; position: the new token's position, a Python int
    or a 0-d tensor (read once, here, so every layer's key range is known
    on the host).  Returns (logits (B,1,V), cache); the cache is the one
    passed in, updated in place.  An encoder-decoder model's
    ``cache["enc_kv"]`` (built by ``prefill``) is read, never written.
    The tree is checked as ``prefill`` checks it (``_check_tree``), and
    the recurrent states against it (``_check_states``): over a model
    axis above 1, ``params``, ``token`` and ``cache`` may be this rank's
    blocks, rows, kv heads, channels and heads (``prefill``'s cache on
    the rank), and the logits come back whole on every rank."""
    ctx = LOCAL_CTX if ctx is None else ctx
    _check_tree(params, cfg, ctx)
    _check_states(params, cache, cfg)
    x = embed_tokens(params, token, cfg, ctx)
    x = _decode_groups(params, x, cache, int(position), cfg, ctx, 0,
                       cfg.num_groups())
    x = apply_norm(params["final_norm"], x)
    return gather_vocab(unembed(params, x, cfg, ctx), cfg, ctx), cache


def _decode_groups(params, x, cache, position: int, cfg, ctx, start: int,
                   stop: int):
    enc_kv = cache.get("enc_kv") or {"groups": {}, "tail": {}}
    for g in range(start, stop):
        gp = _tree_index(params["blocks"], g)
        gc = _tree_index(cache["groups"], g)
        genc = _tree_index(enc_kv["groups"], g)
        for i, kind in enumerate(cfg.block_pattern):
            x, _ = _decode_block(kind, gp[f"b{i}"], x, cfg, ctx,
                                 gc[f"b{i}"], position, genc.get(f"b{i}"))
    if stop == cfg.num_groups():
        for i, kind in enumerate(cfg.tail_pattern()):
            x, _ = _decode_block(kind, params["tail"][f"t{i}"], x, cfg, ctx,
                                 cache["tail"][f"t{i}"], position,
                                 enc_kv["tail"].get(f"t{i}"))
    return x


def decode_layer_range(params, x, cache, position, cfg,
                       ctx: ShardCtx = LOCAL_CTX, *, start_group: int,
                       stop_group: int):
    """One decode step of pattern groups [start_group, stop_group) over
    the hidden state ``x`` (B,1,d) at ``position``, and of the tail when
    ``stop_group == G``: the decode counterpart of ``run_layer_range``.
    ``cache`` (the whole model's, as ``decode_step`` takes it) is read
    and written in place for those groups only; the tree and the states
    are checked as ``decode_step`` checks them."""
    ctx = LOCAL_CTX if ctx is None else ctx
    G = cfg.num_groups()
    if not 0 <= start_group <= stop_group <= G:
        raise ValueError(f"group range [{start_group}, {stop_group}) "
                         f"outside [0, {G}]")
    _check_tree(params, cfg, ctx)
    _check_states(params, cache, cfg)
    return _decode_groups(params, x, cache, int(position), cfg, ctx,
                          start_group, stop_group)


# ==========================================================================
# Segmentation hook: run a range of groups (the paper's split)
# ==========================================================================
def run_layer_range(params, x, cfg, ctx, *, start_group: int, stop_group: int,
                    positions, enc_out=None, kernels=None):
    """Run pattern groups [start_group, stop_group) over hidden states x,
    and the tail when ``stop_group == G``."""
    G = cfg.num_groups()
    if not 0 <= start_group <= stop_group <= G:
        raise ValueError(f"group range [{start_group}, {stop_group}) "
                         f"outside [0, {G}]")
    for g in range(start_group, stop_group):
        gp = _tree_index(params["blocks"], g)
        for i, kind in enumerate(cfg.block_pattern):
            x, _, _ = apply_block_seq(
                kind, gp[f"b{i}"], x, cfg, ctx, positions=positions,
                enc_out=enc_out, kernels=kernels)
    if stop_group == G:
        for i, kind in enumerate(cfg.tail_pattern()):
            x, _, _ = apply_block_seq(
                kind, params["tail"][f"t{i}"], x, cfg, ctx,
                positions=positions, enc_out=enc_out, kernels=kernels)
    return x
