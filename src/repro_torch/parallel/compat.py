"""Process groups and meshes of the port.

The counterpart of the reference's ``parallel/compat.py``.  Where the
reference's collectives take the name of a mesh axis inside
``shard_map``, the port's take a process group, ``None`` meaning the
default group: ``axis_size`` and ``axis_index`` are the group's size
and this process's rank in it, and ``global_rank`` maps a rank of the
group to the global rank that point-to-point operations address.

``make_mesh(shape, axes)`` lays the mesh over global ranks ``0 ..
prod(shape) - 1`` in row-major order, as ``jax.make_mesh`` lays it over
devices, and makes one process group for each slice along the data
axes (``"pod"`` and ``"data"``): the ranks that share every other
coordinate.  ``Mesh.dp_group`` is this process's.  A ``Mesh`` built
directly (``groups=None``) is abstract: it has a shape and names, and
serves sharding rules and specs without any process group.
``set_mesh`` installs a mesh for the current thread, as ``jax.set_mesh``
does.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "global_rank", "Mesh", "make_mesh",
           "set_mesh", "current_mesh", "DP_AXES", "group_device",
           "barrier"]

#: the mesh axes data parallelism spans
DP_AXES = ("pod", "data")

_state = threading.local()


def axis_size(group=None) -> int:
    """Number of ranks in ``group`` (``None``: the default group)."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This process's rank within ``group``."""
    return dist.get_rank(group)


def global_rank(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def group_device(group=None) -> torch.device:
    """Where a tensor must lie for ``group``'s collectives: this
    process's card under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    """Every rank of ``group`` reaches this point before any leaves it
    (an all-reduce of one element on the group's device)."""
    t = torch.zeros(1, device=group_device(group))
    dist.all_reduce(t, group=group)
    if t.is_cuda:
        torch.cuda.current_stream().synchronize()


@dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: ``shape`` maps each axis name to its size, in
    order, as the reference mesh's ``.shape`` does.  ``groups`` maps the
    coordinates off the data axes to the process group of that slice
    (``None`` for an abstract mesh).  Global rank r sits at the
    row-major coordinate r."""
    shape: dict
    groups: dict | None = field(default=None, compare=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: int) -> dict:
        """The coordinates of global rank ``rank`` (row-major)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on the mesh "
                             f"{dict(self.shape)}")
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    @property
    def dp_group(self):
        """This process's data-parallel process group."""
        if self.groups is None:
            raise ValueError("an abstract mesh has no process groups; "
                             "build one with make_mesh")
        c = self.coords(dist.get_rank())
        return self.groups[tuple(c[a] for a in self.axis_names
                                 if a not in DP_AXES)]


def _dp_slices(shape: dict) -> dict:
    """For each coordinate off the data axes, the global ranks of its
    data-parallel slice, in data-axis order."""
    names = tuple(shape)
    others = [n for n in names if n not in DP_AXES]
    out = {}
    for rank, coord in enumerate(itertools.product(
            *(range(shape[n]) for n in names))):
        c = dict(zip(names, coord))
        out.setdefault(tuple(c[n] for n in others), []).append(rank)
    return out


def make_mesh(shape, axes, axis_types=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    global ranks of the initialised default group, with its data-axis
    process groups.  Every process of the world must call it, in the
    same order as its other group creations.  ``axis_types`` is taken
    for the reference's signature and ignored: every axis of the port is
    an explicit process group."""
    del axis_types
    shape = dict(zip(axes, shape, strict=True))
    n = math.prod(shape.values())
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{world}")
    groups = {}
    for key, ranks in _dp_slices(shape).items():
        groups[key] = (dist.group.WORLD if len(ranks) == world
                       else dist.new_group(ranks))
    return Mesh(shape=shape, groups=groups)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None):
    """Install ``mesh`` for this thread for the body of the ``with``."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
