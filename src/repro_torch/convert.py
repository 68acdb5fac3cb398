"""Parameter trees carried between the reference and the port.

The reference's parameters are nested dicts/lists of arrays with ``None``
leaves; the port keeps the very same nesting with ``torch.Tensor``
leaves.  The caller hands over numpy arrays (it maps ``np.asarray`` over
its own tree), so this module never sees an array of another framework.
No leaf is transposed: dense weights are ``(in, out)`` and convolution
weights OIHW on both sides.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device


IsLeaf = Optional[Callable[[Any], bool]]


def _is_node(x: Any, is_leaf: IsLeaf) -> bool:
    return (isinstance(x, (dict, list, tuple))
            and not (is_leaf is not None and is_leaf(x)))


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict/list/tuple, keeping
    ``None`` leaves and the nesting as they are."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves_with_path(tree: Any,
                          is_leaf: IsLeaf = None) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    list and tuple items in order, ``None`` an empty subtree, and a node
    for which ``is_leaf`` is true a leaf (as jax's ``is_leaf``).  A path
    is the tuple of keys and indices from the root."""
    if tree is None:
        return []
    if not _is_node(tree, is_leaf):
        return [((), tree)]
    items = ([(k, tree[k]) for k in sorted(tree)] if isinstance(tree, dict)
             else list(enumerate(tree)))
    return [((k,) + path, leaf) for k, v in items
            for path, leaf in tree_leaves_with_path(v, is_leaf)]


def tree_leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    """The leaves in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_unflatten(template: Any, leaves: List[Any],
                   is_leaf: IsLeaf = None) -> Any:
    """``template``'s nesting with its leaves replaced, in
    ``tree_leaves``' order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node, is_leaf):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return type(node)(build(v) for v in node)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def keystr(path: tuple) -> str:
    """A path as ``jax.tree_util.keystr`` writes it: ``['params']['blocks']
    ['b0']['wq']`` for dict keys, ``[0]`` for sequence indices."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_to_torch(a, device: torch.device,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: the bits travel as uint16
        t = torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()
        ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def from_jax_params(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict/list/``None`` of numpy arrays -> the same nesting of
    ``torch.Tensor`` on ``device``, leaf for leaf.  ``dtype`` casts every
    leaf; ``None`` keeps each leaf's own type."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev, dtype), tree)


def _leaf_to_numpy(t: torch.Tensor, bf16) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bf16 of its own: the bits travel as uint16
        return t.view(torch.uint16).numpy().view(bf16)
    return t.numpy()


def to_numpy_params(tree: Any, bf16=np.uint16) -> Any:
    """The way back: torch leaves -> numpy arrays, same nesting.  A bf16
    leaf comes back as its uint16 bits viewed as ``bf16``: the bits
    themselves by default, or a caller's bf16 dtype such as
    ``ml_dtypes.bfloat16`` (which the port does not import)."""
    return tree_map(lambda t: _leaf_to_numpy(t, bf16), tree)
