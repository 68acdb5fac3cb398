"""Sharded, atomic, resumable checkpointing (counterpart of
``repro/train/checkpoint.py``), in the reference's on-disk layout, so a
checkpoint written by either package restores in the other:

  <dir>/step_<N>/
      manifest.json        leaf keys, shapes, dtypes, volumes, metadata
      shard_<k>.npz        leaf buffers, split into ~512MB volumes
  <dir>/LATEST             text file with the newest complete step

Leaf keys are written as ``jax.tree_util.keystr`` writes them
(``['params']['blocks']['b0']['wq']``), in its order, without jax.
numpy's savez cannot store bf16 (nor float8), so such a leaf is stored
as a same-width unsigned view and its dtype's name kept in the manifest;
torch reads the view back without ``ml_dtypes``.

Writes go to ``step_<N>.tmp`` and are renamed only after every volume is
flushed, so a crash mid-save never corrupts the restore path.
``restore`` returns a tree of CPU tensors.  ``reshard`` places a tree
on a mesh of ranks: where the reference's returns global arrays that jax
lays out over its devices, the port's returns this rank's own blocks
(``distributed/sharding.py::local_shard``), each a fresh tensor on the
rank's device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.convert import keystr, tree_leaves_with_path, tree_unflatten
from repro_torch.distributed import sharding

_VOLUME_BYTES = 512 * 1024 * 1024
# the dtypes numpy cannot store, by the name the manifest gives them: the
# torch dtype, the same-width unsigned view written to disk, and the view
# torch reads it through (torch.from_numpy takes int16, not uint16)
_VIEWS = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
          "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8)}


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    for name, (dtype, stored, readable) in _VIEWS.items():
        if t.dtype == dtype:
            as_int = torch.from_numpy(np.zeros(0, readable)).dtype
            return t.view(as_int).numpy().view(stored), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype in _VIEWS:
        dtype, _, readable = _VIEWS[logical_dtype]
        return torch.from_numpy(np.array(arr).view(readable)).view(dtype)
    return torch.from_numpy(np.array(arr))


def _flatten(tree) -> Dict[str, torch.Tensor]:
    return {keystr(path): leaf for path, leaf in tree_leaves_with_path(tree)}


def save(ckpt_dir: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> str:
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    # pack leaves into volumes
    volumes, vol, vol_bytes = [], {}, 0
    dtypes, shapes = {}, {}
    for key in sorted(flat):
        arr, logical = _to_storable(flat[key])
        dtypes[key] = logical
        shapes[key] = list(arr.shape)
        vol[key] = arr
        vol_bytes += arr.nbytes
        if vol_bytes >= _VOLUME_BYTES:
            volumes.append(vol)
            vol, vol_bytes = {}, 0
    if vol:
        volumes.append(vol)
    index = {}
    for i, v in enumerate(volumes):
        name = f"shard_{i:05d}.npz"
        np.savez(os.path.join(tmp, name), **{k: a for k, a in v.items()})
        for k in v:
            index[k] = name
    manifest = {
        "step": step,
        "leaves": {k: {"shape": shapes[k], "dtype": dtypes[k],
                       "volume": index[k]}
                   for k in flat},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                 # atomic commit
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{step:08d}")):
        return step
    # LATEST pointed at a deleted dir: fall back to scanning
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any,
            step: Optional[int] = None) -> Tuple[int, Any, Dict]:
    """Returns (step, ``template``'s tree of CPU tensors, metadata)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    cache: Dict[str, Any] = {}
    flat = {}
    for key, spec in manifest["leaves"].items():
        vol = spec["volume"]
        if vol not in cache:
            cache[vol] = np.load(os.path.join(d, vol))
        flat[key] = _from_storable(cache[vol][key], spec["dtype"])
    tree = tree_unflatten(template, [
        flat[keystr(path)] for path, _ in tree_leaves_with_path(template)])
    return step, tree, manifest["metadata"]


def reshard(tree, shardings, device: DeviceLike = None):
    """This rank's blocks of ``tree`` (host or device tensors, whole) by
    ``shardings`` (a ``sharding.named`` tree of the same nesting): each a
    fresh, contiguous tensor on ``device`` (``None`` = the GPU), sharing
    no memory with ``tree``, so the whole tree can be dropped (elastic
    restore onto a different mesh)."""
    dev = resolve_device(device)

    def one(path, x, s):
        block = sharding.local_shard(x, s.spec, s.mesh)
        out = torch.empty(block.shape, dtype=block.dtype, device=dev)
        return out.copy_(block)
    return sharding.tree_map_with_path(one, tree, shardings)


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
