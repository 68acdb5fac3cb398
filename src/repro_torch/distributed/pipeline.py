"""GPipe-style pipeline parallelism over a mesh axis, on
``torch.distributed``.

The multi-pod mesh's "pod" axis can host pipeline stages instead of outer
data parallelism when a model's layers do not fit one pod's HBM even with
TP=16 (the 1000+-node deployment case).  This module implements the
schedule with explicit point-to-point sends:

  * stage s holds layer groups [s*G/S, (s+1)*G/S) (params sharded over the
    stage axis on their group dim);
  * M microbatches flow through S stages in M+S-1 ticks: at tick t stage
    s runs microbatch t-s and sends its activation to stage s+1;
  * outputs are collected on the last stage and broadcast from it.

Each rank runs its own stage eagerly and skips its bubble ticks, where
the reference runs ``stage_fn`` and masks the result: the values are the
same.  Activations travel as ``collectives.Wire`` says (through pinned
host memory on ``gloo``).

Bubble fraction = (S-1)/(M+S-1) — reported by ``bubble_fraction`` so the
launcher can size M.  Forward-only (serving / the paper's cloud side);
training PP would add the 1F1B backward schedule on the same skeleton.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import (
    HopStats,
    Wire,
    global_rank,
    resolve_group,
)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stage_slice(stage_params, idx: int, n_stages: int):
    """Stage ``idx``'s parameters: ``stage_params`` is a tree (dicts of
    tensors) whose leaves have leading dim ``n_stages``, as the
    reference's.  Only entry ``idx`` of each leaf is read, so the other
    entries may be anything of its shape: a rank need not hold another
    stage's parameters (its own leaf ``expand``-ed to ``n_stages`` is a
    zero-copy tree of that form)."""
    def leaf(a):
        if isinstance(a, dict):
            return {k: leaf(v) for k, v in a.items()}
        if a is None:
            return None
        if a.shape[0] != n_stages:
            raise ValueError(f"a leaf of leading dim {a.shape[0]} for "
                             f"{n_stages} stages")
        return a[idx]
    return leaf(stage_params)


def gpipe_forward(stage_fn: Callable, stage_params, micro_x, *, mesh,
                  axis_name: str, stats: HopStats = None):
    """Run microbatches through pipeline stages.

    stage_fn(params_local, x) -> y        (one stage's compute; y has the
                                           shape and dtype of x)
    stage_params: see ``stage_slice``; this rank reads its own stage's
    micro_x: (M, micro_batch, ...) inputs (the same on every rank; only
    stage 0 reads them)
    Returns (M, micro_batch, ...) outputs, the same on every rank of the
    axis.  Every rank of the mesh calls it (each runs its own stage).
    """
    n_stages = mesh.shape[axis_name]
    group = resolve_group(axis_name, mesh, None)
    idx = mesh.axis_index(axis_name)
    p_local = stage_slice(stage_params, idx, n_stages)
    M = micro_x.shape[0]
    wire = Wire(group, micro_x, stats)
    last = n_stages - 1
    outs = torch.empty_like(micro_x) if idx == last else None
    sending = None                          # the send still in flight
    for mb in range(M):                     # tick mb + idx; bubbles skipped
        if idx == 0:
            x = micro_x[mb]
        else:
            buf = wire.empty(micro_x.shape[1:], micro_x.dtype)
            wire.wait(wire.post([dist.P2POp(
                dist.irecv, buf, global_rank(group, idx - 1), group)]))
            x = wire.back(buf)
        y = stage_fn(p_local, x)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"stage_fn gave {tuple(y.shape)} {y.dtype} "
                             f"for {tuple(x.shape)} {x.dtype}")
        if idx == last:
            outs[mb] = y
            continue
        if sending is not None:
            wire.wait(sending[0])
        w = wire.out(y)                     # kept alive until its wait
        sending = (wire.post([dist.P2POp(
            dist.isend, w, global_rank(group, idx + 1), group)], sent=w), w)
    if sending is not None:
        wire.wait(sending[0])
    # every stage gets the last stage's collected outputs
    w = wire.out(outs) if idx == last else wire.empty(micro_x.shape,
                                                      micro_x.dtype)
    dist.broadcast(w, src=global_rank(group, last), group=group)
    return outs if idx == last else wire.back(w)
