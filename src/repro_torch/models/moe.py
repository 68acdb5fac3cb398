"""Mixture-of-Experts: the sharding context the model code takes.

Counterpart of ``repro/models/moe.py``, so far only ``ShardCtx`` and
``LOCAL_CTX``, which ``transformer.py`` takes in its signatures.  The
port runs single-device (``mesh=None``); expert routing and dispatch are
still to be ported (ROADMAP A5), and the MoE entry points say so.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.compat import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How model code should shard itself.  mesh=None => single-device."""
    mesh: Optional[object] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]


LOCAL_CTX = ShardCtx(mesh=None, data_axes=(), model_axis=None)

_NOT_PORTED = ("Mixture-of-Experts layers are not ported yet "
               "(ROADMAP A5: MoE comes after SSD and decode)")


def init_moe(generator, cfg, device: DeviceLike = None):
    resolve_device(device)           # no GPU and no device: that first
    raise NotImplementedError(_NOT_PORTED)


def apply_moe(p, x, cfg, ctx: ShardCtx = LOCAL_CTX):
    raise NotImplementedError(_NOT_PORTED)
