"""Sharding rules: params (TP/EP), activations (DP/SP), optimizer (ZeRO-1).

Counterpart of ``repro/distributed/sharding.py``.  The rules are the
reference's, and the bodies of ``_divisible``, ``param_spec`` and
``zero1_spec`` are its text (pinned in ``tests/test_torch_sharding.py``).
What jax supplied, the port keeps itself:

  * ``P`` is a ``PartitionSpec`` of its own, a ``tuple`` of mesh axis
    entries (an axis name, a tuple of them, or ``None``) with jax's
    ``repr``; like jax's, it writes a one-name tuple as the name;
  * the tree walk (``convert``'s, with a ``P`` a leaf) gives each rule the
    path string that ``jax.tree_util.keystr`` gives
    (``"['blocks']['b0']['moe']['w_gate']"``), since the rules branch on
    its substrings;
  * ``named`` returns ``NamedSharding`` records (a mesh and a spec), and
    ``local_shard`` cuts a rank's block out of a whole tensor by its spec.
    ``train/checkpoint.py::reshard`` places a tree by them.

The rules read only ``mesh.shape``, so they run without a world.  The
leaf shapes come from the port's own trees (``init_params`` and
``init_decode_cache`` on the ``meta`` device draw nothing).

Policy summary (the reference's):
  * batch over (pod, data); model-parallel over "model".
  * attention: shard the head dim when divisible by the model axis,
    otherwise leave replicated (e.g. MQA kv=1).
  * MLP: d_ff over model (megatron TP pattern: col-parallel in,
    row-parallel out => one psum per block).
  * MoE: per ``cfg.moe.partitioning``: "tp" shards each expert's d_ff,
    "ep" shards the expert dim (requires divisibility — olmoe's 64).
  * vocab: embed (V, d) -> V over model; lm_head (d, V) -> V over model.
  * decode KV caches: batch over data; kv-heads over model when divisible,
    else the sequence dim over model (flash-decoding style).
  * ZeRO-1: optimizer leaves additionally sharded over the data axes on
    the first free divisible dimension.

Prefill and decode compute on a tree cut wholly by these rules over a
model axis (``models/transformer.py``: attention and cross-attention by
heads, an encoder's blocks as the decoder's, the dense MLP by ``d_ff``,
the RG-LRU by channels, the SSD by ``d_inner`` in whole heads, the
vocabulary; a MoE layer in ``models/moe.py``'s modes); ``local_shapes``
gives a rank's leaf shapes, against which the model checks the tree it
is handed.  Where the kv heads do not divide the model axis, a rank's
cache (``enc_kv`` too) holds all of them, not the ``cache_specs`` block
of the sequence; a rank's SSD ``conv`` state is [its x channels | B |
C], not the ``cache_specs`` block of the whole [x | B | C] (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import (keystr, tree_leaves, tree_leaves_with_path,
                                tree_unflatten)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.moe import ShardCtx


class P(tuple):
    """A partition spec: one entry a dimension, each ``None`` (not cut),
    a mesh axis name, or a tuple of names (cut over their product, the
    first name outermost).  Missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec({', '.join(map(repr, self))})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's block of a leaf lies."""
    mesh: Any
    spec: P


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map_with_path(fn, tree, *rest):
    """``fn(keystr(path), leaf, *rest_leaves)`` over ``tree``'s leaves, in
    its nesting (``jax.tree_util.tree_map_with_path`` with the path as
    ``keystr`` writes it), on ``convert``'s walk with a ``P`` a leaf.
    ``rest`` are trees of ``tree``'s nesting."""
    pairs = tree_leaves_with_path(tree, _is_spec)
    others = [tree_leaves(r, _is_spec) for r in rest]
    if any(len(o) != len(pairs) for o in others):
        raise ValueError("trees of different nesting")
    return tree_unflatten(tree, [
        fn(keystr(path), leaf, *(o[i] for o in others))
        for i, (path, leaf) in enumerate(pairs)], _is_spec)


# --------------------------------------------------------------------------
# Param rules
# --------------------------------------------------------------------------
def _divisible(n: int, mesh: Mesh, axis) -> bool:
    if axis is None:
        return False
    size = (np.prod([mesh.shape[a] for a in axis])
            if isinstance(axis, tuple) else mesh.shape[axis])
    return n % int(size) == 0


def param_spec(path: str, shape: Tuple[int, ...], cfg, mesh: Mesh,
               model_axis: str = "model") -> P:
    """PartitionSpec for one (possibly group-stacked) param leaf."""
    m = model_axis
    stacked = path.count("blocks") > 0 or "/encoder/" in path.replace("']['", "/")
    # normalize path: keystr gives ['blocks']['b0']['wq'] style
    key = path.replace("']['", "/").strip("[']")
    leading: Tuple = ()
    ndim = len(shape)

    def spec(*axes):
        # pad to ndim with None
        out = list(axes) + [None] * (ndim - len(axes))
        return P(*out)

    is_stacked = bool(re.search(r"(blocks|encoder/blocks)/", key)) and ndim >= 1
    body = shape[1:] if is_stacked else shape
    lead = (None,) if is_stacked else ()

    def bspec(*axes):
        out = list(lead) + list(axes)
        out += [None] * (ndim - len(out))
        return P(*out)

    leaf = key.split("/")[-1]
    if leaf == "embed":
        return spec(m if _divisible(shape[0], mesh, m) else None, None)
    if leaf == "lm_head":
        return spec(None, m if _divisible(shape[1], mesh, m) else None)
    if leaf == "frontend_proj":
        return spec(None, None)
    # dense mlp (scoped BEFORE attention: mlp/wo is rank-2, block wo rank-3)
    if "mlp" in key:
        if leaf in ("wi_gate", "wi_up", "wi"):
            return bspec(None, m if _divisible(body[1], mesh, m) else None)
        if leaf == "wo":
            return bspec(m if _divisible(body[0], mesh, m) else None, None)
    # attention
    if leaf in ("wq", "wk", "wv", "xwq", "xwk", "xwv"):
        h = body[1]
        return bspec(None, m if _divisible(h, mesh, m) else None, None)
    if leaf in ("wo", "xwo"):
        h = body[0]
        return bspec(m if _divisible(h, mesh, m) else None, None, None)
    if leaf in ("bq", "bk", "bv"):
        h = body[0]
        return bspec(m if _divisible(h, mesh, m) else None, None)
    # moe
    if "moe" in key:
        ep = cfg.moe is not None and cfg.moe.partitioning == "ep" and \
            _divisible(cfg.moe.num_experts, mesh, m)
        if leaf == "router":
            return bspec(None, None)
        if leaf in ("w_gate", "w_up", "w_in"):
            return bspec(m, None, None) if ep else bspec(
                None, None, m if _divisible(body[2], mesh, m) else None)
        if leaf == "w_down":
            return bspec(m, None, None) if ep else bspec(
                None, m if _divisible(body[1], mesh, m) else None, None)
    # rglru
    if "rglru" in key:
        if leaf in ("w_rec_in", "w_gate_in"):
            return bspec(None, m if _divisible(body[1], mesh, m) else None)
        if leaf == "conv_w":
            return bspec(None, m if _divisible(body[1], mesh, m) else None)
        if leaf in ("wa", "wx"):
            return bspec(m if _divisible(body[0], mesh, m) else None, None, None)
        if leaf in ("ba", "bx", "lam"):
            return bspec(m if _divisible(body[0], mesh, m) else None)
        if leaf == "w_out":
            return bspec(m if _divisible(body[0], mesh, m) else None, None)
    # ssd — x/z (d_inner-wide, head-aligned) shard over model; the small
    # B/C/dt projections stay replicated so the SSD scan is shard-local
    if "ssd" in key:
        if leaf in ("z_proj", "x_proj", "in_proj"):
            return bspec(None, m if _divisible(body[1], mesh, m) else None)
        if leaf in ("b_proj", "c_proj", "dt_proj", "conv_b", "conv_c"):
            return bspec(None, None)
        if leaf == "out_proj":
            return bspec(m if _divisible(body[0], mesh, m) else None, None)
        if leaf in ("conv_w", "conv_x"):
            return bspec(None, m if _divisible(body[1], mesh, m) else None)
        if leaf == "norm_scale":
            return bspec(m if _divisible(body[0], mesh, m) else None)
        if leaf in ("A_log", "dt_bias", "D"):
            return bspec(None)
    # norms, biases, scalars
    return P(*([None] * ndim))


def param_specs(params, cfg, mesh: Mesh, model_axis: str = "model"):
    """``param_spec`` of every leaf of ``params`` (tensors or anything
    with a ``shape``), in the tree's nesting."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), cfg, mesh,
                                      model_axis), params)


def local_shape(shape: Tuple[int, ...], spec: P, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec`` (``local_shard``'s, without a tensor); raises where an
    entry's axes do not divide its dimension."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(mesh.shape[a] for a in axes)
        if out[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {axes} ({n} blocks)")
        out[dim] //= n
    return tuple(out)


def local_shapes(cfg, mesh: Mesh, model_axis: str = "model"):
    """{``keystr`` path: shape} of every parameter leaf of ``cfg``'s tree
    on one rank of ``mesh`` under ``param_specs`` (every rank's block has
    the same shape).  Computed once for a config and a mesh shape, on the
    ``meta`` device (nothing is drawn); the dict is shared, not to be
    written."""
    return _local_shapes(cfg, tuple(mesh.shape.items()), model_axis)


@functools.lru_cache(maxsize=None)
def _local_shapes(cfg, axes, model_axis):
    # the model imports this module: import it here, at the first call
    from repro_torch.models import transformer
    mesh = Mesh([n for _, n in axes], [a for a, _ in axes])
    tree = transformer.init_params(cfg, torch.Generator(), "meta")
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        key, shape = keystr(path), tuple(leaf.shape)
        out[key] = local_shape(shape, param_spec(key, shape, cfg, mesh,
                                                 model_axis), mesh)
    return out


# --------------------------------------------------------------------------
# ZeRO-1 optimizer-state specs
# --------------------------------------------------------------------------
def zero1_spec(shape: Tuple[int, ...], pspec: P, mesh: Mesh,
               data_axes: Tuple[str, ...]) -> P:
    """Add the data axes to the first free, divisible dim of the spec."""
    size = int(np.prod([mesh.shape[a] for a in data_axes]))
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % size == 0 and dim > 0:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return P(*entries)
    return P(*entries)  # nothing divisible: stays as-is (small leaf)


def opt_state_specs(opt_state, params_specs, mesh: Mesh,
                    data_axes: Tuple[str, ...]):
    """Specs for {"step", "master", "m", "v"} given the param specs."""
    def tree_specs(tree):
        return tree_map_with_path(
            lambda path, leaf, ps: zero1_spec(tuple(leaf.shape), ps, mesh,
                                              data_axes),
            tree, params_specs)

    return {
        "step": P(),
        "master": tree_specs(opt_state["master"]),
        "m": tree_specs(opt_state["m"]),
        "v": tree_specs(opt_state["v"]),
    }


# --------------------------------------------------------------------------
# Batch / cache specs
# --------------------------------------------------------------------------
def batch_specs(batch, data_axes: Tuple[str, ...], mesh: Optional[Mesh] = None):
    d = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize = (int(np.prod([mesh.shape[a] for a in data_axes]))
             if mesh is not None else 1)

    def one(path, leaf):
        if mesh is not None and leaf.shape[0] % dsize != 0:
            return P(*([None] * leaf.ndim))      # e.g. global_batch=1 decode
        out = [d] + [None] * (leaf.ndim - 1)
        return P(*out)
    return tree_map_with_path(one, batch)


def cache_specs(cache, cfg, mesh: Mesh, data_axes: Tuple[str, ...],
                model_axis: str = "model"):
    """Decode-cache specs (see policy above).  Works on the tree from
    ``transformer.init_decode_cache``."""
    d = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    m = model_axis

    def one(key, leaf):
        shape = leaf.shape
        stacked = "groups" in key
        i0 = 1 if stacked else 0        # index of batch dim
        entries: list = [None] * leaf.ndim
        if shape[i0] % dsize == 0:
            entries[i0] = d
        leafname = key.replace("']['", "/").strip("[']").split("/")[-1]
        if leafname in ("k", "v"):
            # (..., B, S, kvH, hd): kv-heads over model if divisible, else seq
            kvh = shape[i0 + 2]
            if _divisible(kvh, mesh, m):
                entries[i0 + 2] = m
            elif _divisible(shape[i0 + 1], mesh, m):
                entries[i0 + 1] = m
        elif leafname == "h":            # rglru state (..., B, W)
            if _divisible(shape[-1], mesh, m):
                entries[-1] = m
        elif leafname == "conv":         # (..., B, K-1, width)
            if _divisible(shape[-1], mesh, m):
                entries[-1] = m
        elif leafname == "ssm":          # (..., B, H, P, N)
            if _divisible(shape[i0 + 1], mesh, m):
                entries[i0 + 1] = m
        return P(*entries)

    return tree_map_with_path(one, cache)


def make_ctx(mesh: Optional[Mesh]) -> ShardCtx:
    if mesh is None:
        return ShardCtx(mesh=None, data_axes=(), model_axis=None)
    axes = tuple(mesh.axis_names)
    data_axes = tuple(a for a in axes if a != "model")
    return ShardCtx(mesh=mesh, data_axes=data_axes, model_axis="model")


def named(mesh: Mesh, spec_tree):
    return tree_map_with_path(lambda path, s: NamedSharding(mesh, s),
                              spec_tree)


def moe_only_specs(params, cfg, mesh: Mesh, model_axis: str = "model"):
    """``param_specs`` with every leaf outside a Mixture-of-Experts layer
    left whole (all ``None``): each rank computes attention and the
    embeddings with whole weights (no sum over the model axis) and only
    its MoE layer on its block (``models/moe.py``'s ``tp`` and ``ep``).
    A tree cut wholly by ``param_specs`` runs too, attention then cut by
    heads (``models/transformer.py``'s dense tensor parallelism)."""
    specs = param_specs(params, cfg, mesh, model_axis)
    return tree_map_with_path(
        lambda path, s: s if "['moe']" in path else P(*([None] * len(s))),
        specs)


def local_shard(t: torch.Tensor, spec: P, mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s block of the whole tensor ``t`` under ``spec`` (this
    process's rank by default), as a view.  An entry naming several axes
    cuts the dimension over their product, the first axis outermost (row
    major over the axes' coordinates, as jax lays out such a dimension).
    Raises where the spec has more entries than ``t`` has dimensions or an
    entry's axes do not divide its dimension."""
    if len(spec) > t.ndim:
        raise ValueError(f"{spec!r} has more entries than the shape "
                         f"{tuple(t.shape)}")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(mesh.shape[a] for a in axes)
        index = 0
        for a in axes:
            index = index * mesh.shape[a] + mesh.axis_index(a, rank)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n} blocks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, index * size, size)
    return t
