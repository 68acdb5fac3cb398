"""AdamW with fp32 master weights (counterpart of
``repro/train/optimizer.py``).

Mixed-precision contract, as the reference's:
  * model params are bf16 (compute dtype),
  * optimizer state holds fp32 master weights + fp32 m/v,
  * each step updates masters and re-casts to the params' own dtypes.

Trees are flattened in ``jax.tree_util``'s order (dict keys sorted), so
``global_norm`` sums its leaves in the reference's order.  The reference
donates its state to the jitted step; here ``apply_updates`` updates the
state's m, v and masters in place and returns a new state dict holding
them, and new parameter tensors.

ZeRO-1 (``train/train_loop.py`` under a data mesh): each rank holds its
block of ``master``, ``m`` and ``v`` (``sharding.opt_state_specs``) and
calls ``apply_updates`` on the blocks of the summed gradients, with the
norm of the whole summed tree passed in as ``grad_norm``.  The update is
elementwise, so a rank's blocks come out as the blocks of the whole
tree's update, to the bit.

Dense tensor parallelism (``train/train_loop.py`` over a model axis):
each rank holds its ``param_specs`` blocks of the parameters and their
state and calls ``apply_updates`` on them, with the norm of the whole
gradient (``global_norm`` with ``cut`` and ``model_sum``) as
``grad_norm``: every rank clips alike, and a leaf held whole is updated
alike on every rank.  Over a data axis too, the state is the ZeRO-1
blocks of the rank's model blocks, and the norm is that of the summed
model blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.convert import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * peak, in fp32 (on
    ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio
                                 + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """step 0, fp32 copies of the params (never aliasing them), zero m and
    v, on the params' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                      params),
        "v": tree_map(lambda x: torch.zeros(x.shape, device=x.device),
                      params),
    }


def global_norm(tree, *, cut: Optional[Sequence[bool]] = None,
                model_sum: Optional[Callable] = None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together, the leaves' sums
    of squares added in the tree's order.  Where each rank of a model
    axis holds its blocks of some leaves (``cut``, a flag a leaf in that
    order), those leaves' sums of squares are summed over the axis by
    ``model_sum`` (one call, all of them stacked), and the leaves held
    whole are counted once: every rank gets the whole tree's norm."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    if cut is not None and any(cut):
        mine = [i for i, c in enumerate(cut) if c]
        summed = model_sum(torch.stack([leaves[i] for i in mine]))
        for i, total in zip(mine, summed.unbind()):
            leaves[i] = total
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, *,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step.  Returns (new params in their own dtypes, new
    state, metrics).  Only leaves of two or more dimensions decay (norms,
    biases and 1-d gains do not).  The clip reads ``grad_norm`` when it is
    given (the norm of a whole tree of which ``grads`` are blocks), else
    ``global_norm(grads)``."""
    step = state["step"]
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    for g, m, v, w in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]),
                          tree_leaves(state["master"])):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if w.dim() >= 2:
            delta = delta + cfg.weight_decay * w
        w.sub_(lr * delta)
    new_state = {"step": step + 1, "m": state["m"], "v": state["v"],
                 "master": state["master"]}
    new_params = tree_unflatten(params, [
        w.to(p.dtype, copy=True) for w, p in zip(
            tree_leaves(state["master"]), tree_leaves(params))])
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
