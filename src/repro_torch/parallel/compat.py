"""The size and position of a ``torch.distributed`` group.

The counterpart of the reference's ``parallel/compat.py::axis_size`` and
``jax.lax.axis_index``: where the reference's collectives take the name
of a mesh axis inside ``shard_map``, the port's take a process group,
``None`` meaning the default group.  ``global_rank`` maps a rank of the
group to the global rank that point-to-point operations address.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "global_rank"]


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
