"""Mesh construction for the port's launchers, the counterpart of the
reference's ``launch/mesh.py`` (a function: importing this module
touches no process group).

``make_host_mesh(data, model)`` lays a ``("data", "model")`` mesh over
the ranks of the initialised default group (one process a rank, e.g.
under ``torchrun``), as the reference lays it over however many host
devices exist.  The production meshes (256 and 512 chips) come with the
dry-run (ROADMAP A.11c).
"""

from __future__ import annotations

import torch.distributed as dist

from ..parallel.compat import make_mesh

__all__ = ["make_host_mesh"]


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ``(data, model)`` mesh over the world's first
    ``data * model`` ranks."""
    n = dist.get_world_size()
    assert data * model <= n, (data, model, n)
    return make_mesh((data, model), ("data", "model"))
