"""Production meshes, as grids of ``torch.distributed`` ranks.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model") — "pod"
is an outer data-parallel axis (gradient all-reduce spans pod x data; the
serving engine treats pods as replica groups behind one scheduler).

A ``Mesh`` is a description: building one touches no process group, so a
256-rank mesh can be described in a world of one.  ``Mesh.group`` creates
the process groups along an axis when first asked, and needs a world of
at least ``mesh.size`` ranks.  Rank ``r`` of the world is the mesh's
device ``r`` (``mesh.devices`` holds ranks in row-major order), as
``jax.make_mesh`` places the first ``size`` devices.
"""
from __future__ import annotations

import collections
import math
from typing import Sequence

import numpy as np
import torch.distributed as dist


class Mesh:
    """Named axes over a row-major grid of ranks: what the port's callers
    read of a jax ``Mesh`` (``shape``, ``axis_names``, ``size``,
    ``devices``), and the process group of each axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} on axes {axis_names}")
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.devices = np.arange(self.size).reshape(shape)
        self._groups = {}

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"

    def axis_index(self, axis_name: str, rank: int = None) -> int:
        """``rank``'s coordinate along ``axis_name`` (this process's rank
        by default); raises for a rank outside the mesh."""
        rank = dist.get_rank() if rank is None else rank
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside {self!r}")
        coords = np.unravel_index(rank, self.devices.shape)
        return int(coords[self.axis_names.index(axis_name)])

    def group(self, axis_name: str):
        """This rank's process group along ``axis_name``: the ranks that
        differ from it in that coordinate only, in axis order.  The first
        call for an axis creates every one of the axis's groups, in the
        same order on every rank (``dist.new_group`` waits for all ranks
        of the world), so every rank must make it.  A rank outside the
        mesh gets ``GroupMember.NON_GROUP_MEMBER``."""
        if axis_name not in self._groups:
            if dist.get_world_size() < self.size:
                raise ValueError(f"{self!r} needs {self.size} ranks, the "
                                 f"world has {dist.get_world_size()}")
            axis = self.axis_names.index(axis_name)
            lines = np.moveaxis(self.devices, axis, -1).reshape(
                -1, self.devices.shape[axis])
            rank = dist.get_rank()
            mine = dist.GroupMember.NON_GROUP_MEMBER
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = group
            self._groups[axis_name] = mine
        return self._groups[axis_name]


def _world_size() -> int:
    """Ranks in the default process group, 1 when none is initialised
    (the port's count of devices on the host)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Mesh over however many ranks this world actually has (tests)."""
    n = _world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(1, data)))
    return Mesh((data, model), ("data", "model"))


def make_elastic_mesh(pods: int, data: int, model: int) -> Mesh:
    """Rebuild a mesh after failures (fault_tolerance.ElasticPlan)."""
    if pods > 1:
        return Mesh((pods, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))
