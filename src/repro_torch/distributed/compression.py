"""Gradient compression: per-leaf symmetric int8 with error feedback
(counterpart of ``repro/distributed/compression.py``).

``compress_tree_int8`` round-trips every leaf through int8 (quantise ->
dequantise models the wire); ``ErrorFeedback`` carries the quantisation
residual across steps and re-injects it.  Leaves are taken in
``jax.tree_util``'s order.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.convert import tree_leaves, tree_map, tree_unflatten


def _quant_leaf(g):
    gf = g.to(torch.float32)
    if gf.dim() == 0:
        return gf, torch.zeros((), device=gf.device)
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-20)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq, (deq - gf).square().mean()


def compress_tree_int8(grads) -> Tuple[Any, torch.Tensor]:
    """Round-trip every leaf through int8.  Returns (grads', mean MSE)."""
    outs, errs = [], []
    for g in tree_leaves(grads):
        d, e = _quant_leaf(g)
        outs.append(d.to(g.dtype))
        errs.append(e)
    err = torch.stack(errs).mean() if errs else torch.zeros(())
    return tree_unflatten(grads, outs), err


class ErrorFeedback:
    """Residual-carrying compressor: g_t' = Q(g_t + e_{t-1});
    e_t = (g_t + e_{t-1}) - g_t'."""

    @staticmethod
    def init(grads):
        return tree_map(lambda g: torch.zeros(g.shape, device=g.device),
                        grads)

    @staticmethod
    def apply(grads, residual):
        comp, new_res = [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
            x = g.to(torch.float32) + r
            d, _ = _quant_leaf(x)
            comp.append(d.to(g.dtype))
            new_res.append(x - d)
        return tree_unflatten(grads, comp), tree_unflatten(residual, new_res)
