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
coordinate, one for each slice along the other axes (the model axis):
the ranks that share every data coordinate, and, where two data axes
are past size 1, one for each slice along either of them.
``Mesh.dp_group``, ``Mesh.model_group`` and ``Mesh.group_along`` are
this process's.  A ``Mesh`` built
directly (``groups=None``) is abstract: it has a shape and names, and
serves sharding rules and specs without any process group; its
``dp_group`` and ``model_group`` are rank 0's, as ``RecordingGroup``s,
the dry-run's stand-in, whose collectives (``all_reduce``,
``all_gather``, ``all_gather_dim``, ``reduce_scatter``, ``ppermute``
here) report themselves to the active ``launch.cost`` counter and move
nothing; each reports the axis its group spans (``"dp"``, ``"model"``,
or the mesh axes of a group along part of the data axes,
``Mesh.group_along``) and the group's global ranks to the counter,
which the roofline prices by where those ranks lie.
``set_mesh`` installs a mesh for the current thread, as ``jax.set_mesh``
does.

Each collective hands the backend its tensors on ``group_device``: a
CUDA tensor is staged through host memory under gloo (so several ranks
can share one card, each its own process), and moves no byte under
NCCL, where the group's device is the card.  ``CALLS`` counts the
collectives this process has run, by kind (``"all-reduce"``,
``"all-gather"``, ``"reduce-scatter"``, ``"collective-permute"``; a
recorded one is not run, so not counted): a caller zeroes it with
``CALLS.clear()`` and reads it after the work it counts.  What a
collective does to move its tensors (staging copies, the backend's own
operator) is hidden from the counter, which counts the collective's
result bytes instead.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..launch import cost

__all__ = ["axis_size", "axis_index", "global_rank", "Mesh", "make_mesh",
           "set_mesh", "current_mesh", "DP_AXES", "group_device",
           "barrier", "RecordingGroup", "all_reduce", "all_gather",
           "all_gather_dim", "reduce_scatter", "ppermute", "CALLS"]

#: the mesh axes data parallelism spans
DP_AXES = ("pod", "data")

_state = threading.local()

#: the collectives run by this process, by kind
CALLS: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class RecordingGroup:
    """The stand-in process group of an abstract mesh: ``size`` ranks,
    this process rank 0, spanning the mesh axis ``axis`` (``"dp"``,
    ``"model"``, or the axes of ``Mesh.group_along``) over the global
    ``ranks`` (row-major positions on the mesh).  Its collectives move nothing: each reports its kind, result,
    axis and ranks to the active counter and leaves its output as it
    was allocated, with the right shape and dtype.  Calling one with no
    counter active is an error (nothing would be reduced)."""
    size: int
    axis: str | None = field(default=None, compare=False)
    ranks: tuple | None = field(default=None, compare=False)


def _recorded(kind: str, result: torch.Tensor,
              group: RecordingGroup) -> None:
    if cost.active() is None:
        raise RuntimeError(f"{kind} on a RecordingGroup (an abstract "
                           f"mesh) moves nothing and needs an active "
                           f"launch.cost.Counter to record it")
    cost.record_collective(kind, result, axis=group.axis, ranks=group.ranks)


def axis_size(group=None) -> int:
    """Number of ranks in ``group`` (``None``: the default group)."""
    if isinstance(group, RecordingGroup):
        return group.size
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This process's rank within ``group``."""
    if isinstance(group, RecordingGroup):
        return 0
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it (``group_device``): the
    same tensor when it lies there, else a copy."""
    dev = group_device(group)
    return t if t.device.type == dev.type else t.to(dev)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> None:
    """The sum (``op="max"``: the maximum) of ``t`` over ``group``, in
    place."""
    if isinstance(group, RecordingGroup):
        return _recorded("all-reduce", t, group)
    cost.record_collective("all-reduce", t)
    CALLS["all-reduce"] += 1
    with cost.uncounted():
        s = _staged(t, group)
        dist.all_reduce(s, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        if s is not t:
            t.copy_(s)


def all_gather(out: torch.Tensor, t: torch.Tensor, group=None) -> None:
    """Every rank's ``t`` into ``out`` (``(n, *t.shape)``), in rank
    order."""
    if isinstance(group, RecordingGroup):
        return _recorded("all-gather", out, group)
    cost.record_collective("all-gather", out)
    CALLS["all-gather"] += 1
    with cost.uncounted():
        so = _staged(out, group)
        dist.all_gather(list(so.unbind(0)), _staged(t, group), group=group)
        if so is not out:
            out.copy_(so)


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order."""
    n = axis_size(group)
    out = t.new_empty((n, *t.shape))
    all_gather(out, t.contiguous(), group)
    return torch.cat(out.unbind(0), dim)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut into ``axis_size(group)``
    equal blocks along ``dim``: this rank's block (rank r, the r-th)."""
    n = axis_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {n} blocks")
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    if isinstance(group, RecordingGroup):
        _recorded("reduce-scatter", out, group)
    else:
        cost.record_collective("reduce-scatter", out)
        CALLS["reduce-scatter"] += 1
        with cost.uncounted():
            so = _staged(out, group)
            dist.reduce_scatter_tensor(so, _staged(x, group), group=group)
            if so is not out:
                out.copy_(so)
    return out.movedim(0, dim)


def ppermute(t: torch.Tensor, out: torch.Tensor, to: int, frm: int,
             group=None) -> None:
    """Send ``t`` to rank ``to`` of ``group`` and receive rank ``frm``'s
    into ``out`` (one hop of a ring)."""
    if isinstance(group, RecordingGroup):
        return _recorded("collective-permute", out, group)
    cost.record_collective("collective-permute", out)
    CALLS["collective-permute"] += 1
    with cost.uncounted():
        so = _staged(out, group)
        ops = [dist.P2POp(dist.isend, _staged(t, group).contiguous(),
                          global_rank(group, to), group),
               dist.P2POp(dist.irecv, so, global_rank(group, frm), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if so is not out:
            out.copy_(so)


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
    coordinates off the data axes to the process group of that slice,
    ``model_groups`` the coordinates on the data axes to the group of
    theirs (``None`` for an abstract mesh).  Global rank r sits at the
    row-major coordinate r."""
    shape: dict
    groups: dict | None = field(default=None, compare=False)
    model_groups: dict | None = field(default=None, compare=False)
    along_groups: dict | None = field(default=None, compare=False)

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
    def dp_size(self) -> int:
        """Ranks along the data axes."""
        return math.prod(n for a, n in self.shape.items() if a in DP_AXES)

    @property
    def model_size(self) -> int:
        """Ranks along the other axes (the model axis)."""
        return self.size // self.dp_size

    def _mine(self, groups: dict, on_dp: bool):
        c = self.coords(dist.get_rank())
        return groups[tuple(c[a] for a in self.axis_names
                            if (a in DP_AXES) == on_dp)]

    def _recording(self, along_dp: bool) -> RecordingGroup:
        """Rank 0's group along the data axes (``along_dp``) or the
        others, as a ``RecordingGroup``."""
        ranks = tuple(_slices(self.shape, along_dp)[
            (0,) * sum((a in DP_AXES) != along_dp for a in self.shape)])
        return RecordingGroup(len(ranks), "dp" if along_dp else "model",
                              ranks)

    def group_along(self, axes):
        """This process's group along the mesh axes ``axes``, a part of
        the data axes (FSDP over ``"data"`` of a ``(pod, data, model)``
        mesh, and the ``"pod"`` group that completes its gradient's
        sum); an abstract mesh's is rank 0's, a ``RecordingGroup``
        whose axis is named by those mesh axes (``"data"``,
        ``"pod"``)."""
        key = tuple(a for a in self.axis_names if a in axes)
        if self.along_groups is None:
            ranks = tuple(_slices_along(self.shape, key)[
                (0,) * (len(self.shape) - len(key))])
            return RecordingGroup(len(ranks), "+".join(key), ranks)
        c = self.coords(dist.get_rank())
        return self.along_groups[key][tuple(
            c[a] for a in self.axis_names if a not in key)]

    @property
    def dp_group(self):
        """This process's data-parallel process group; an abstract
        mesh's is rank 0's, a ``RecordingGroup``."""
        if self.groups is None:
            return self._recording(along_dp=True)
        return self._mine(self.groups, on_dp=False)

    @property
    def model_group(self):
        """This process's model-axis process group (the ranks sharing
        its data coordinates); an abstract mesh's is rank 0's, a
        ``RecordingGroup``."""
        if self.model_groups is None:
            return self._recording(along_dp=False)
        return self._mine(self.model_groups, on_dp=True)


def _slices(shape: dict, along_dp: bool) -> dict:
    """The global ranks of each slice along the data axes
    (``along_dp``; keyed by the other coordinates) or along the other
    axes (keyed by the data coordinates), in the slice's axis order."""
    return _slices_along(shape, [n for n in shape
                                 if (n in DP_AXES) == along_dp])


def _slices_along(shape: dict, axes) -> dict:
    """The global ranks of each slice along the mesh axes ``axes``,
    keyed by the other coordinates, in the slice's axis order."""
    names = tuple(shape)
    fixed = [n for n in names if n not in axes]
    out = {}
    for rank, coord in enumerate(itertools.product(
            *(range(shape[n]) for n in names))):
        c = dict(zip(names, coord))
        out.setdefault(tuple(c[n] for n in fixed), []).append(rank)
    return out


def _new_groups(slices: dict, world: int) -> dict:
    return {key: (dist.group.WORLD if len(ranks) == world
                  else dist.new_group(ranks))
            for key, ranks in slices.items()}


def make_mesh(shape, axes, axis_types=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    global ranks of the initialised default group, with its data-axis
    and model-axis process groups.  Every process of the world must call
    it, in the same order as its other group creations.  ``axis_types``
    is taken for the reference's signature and ignored: every axis of
    the port is an explicit process group."""
    del axis_types
    shape = dict(zip(axes, shape, strict=True))
    n = math.prod(shape.values())
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{world}")
    # the groups along each proper part of the data axes past size 1
    dp = [a for a in shape if a in DP_AXES and shape[a] > 1]
    parts = [k for n in range(1, len(dp))
             for k in itertools.combinations(dp, n)]
    return Mesh(shape=shape,
                groups=_new_groups(_slices(shape, along_dp=True), world),
                model_groups=_new_groups(_slices(shape, along_dp=False),
                                         world),
                along_groups={k: _new_groups(_slices_along(shape, k), world)
                              for k in parts})


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
