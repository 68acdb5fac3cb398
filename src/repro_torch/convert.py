"""Parameter trees carried between the reference and the port.

The reference's parameters are nested dicts/lists of arrays with ``None``
leaves; the port keeps the very same nesting with ``torch.Tensor``
leaves.  The caller hands over numpy arrays (it maps ``np.asarray`` over
its own tree), so this module never sees an array of another framework.
No leaf is transposed: dense weights are ``(in, out)`` and convolution
weights OIHW on both sides.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device


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


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy_params(tree: Any) -> Any:
    """The way back: torch leaves -> numpy arrays, same nesting."""
    return tree_map(_leaf_to_numpy, tree)
