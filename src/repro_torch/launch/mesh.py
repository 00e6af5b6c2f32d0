"""Mesh construction for the port's launchers, the counterpart of the
reference's ``launch/mesh.py`` (a function: importing this module
touches no process group).

``make_host_mesh(data, model)`` lays a ``("data", "model")`` mesh over
the ranks of the initialised default group (one process a rank, e.g.
under ``torchrun``), as the reference lays it over however many host
devices exist, with this process's data-parallel group
(``mesh.dp_group``, the ranks of its model coordinate) and model-axis
group (``mesh.model_group``, the ranks of its data coordinate).  ``make_production_mesh`` returns the reference's
production meshes (256 and 512 chips) as abstract meshes: shapes and
names only, no process group, what the dry-run traces against.
"""

from __future__ import annotations

import torch.distributed as dist

from ..parallel.compat import Mesh, make_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod over ``("data", "model")``, or 2 pods =
    512 chips over ``("pod", "data", "model")``: data parallelism spans
    pod x data, tensor / expert / sequence parallelism spans model.  An
    abstract mesh: building it touches no device and no process
    group."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1):
    """A small ``(data, model)`` mesh over the world's first
    ``data * model`` ranks, or ``(pod, data, model)`` where ``pod`` is
    past 1, with its process groups (every process of the world calls
    it, as it creates groups)."""
    n = dist.get_world_size()
    assert pod * data * model <= n, (pod, data, model, n)
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
