"""Logical-axis sharding rules for parameters and activations, the port's
copy of the reference's ``parallel/sharding.py``.

Model code names each tensor dimension with a *logical* axis; a
``Rules`` object (a mesh and two name -> mesh-axis tables) resolves the
names to a ``PartitionSpec``: one entry a dimension, each a mesh-axis
name, a tuple of names, or ``None`` (not sharded).  The port's
``PartitionSpec`` is a plain tuple, so it compares equal, entry for
entry, to the reference's.  Without rules installed every annotation is
a no-op.

Mesh axes: ``("pod", "data", "model")`` or ``("data", "model")``.  Data
parallelism spans pod x data; tensor, expert and sequence parallelism
span model.  The default tables are the reference's:

  parameters               embed -> "data" with FSDP, else None;
                           ff, heads_q, vocab, experts, mamba_inner ->
                           "model"; heads_kv -> "model" when
                           (K * d_head) % tp == 0, else None
  activations              batch -> the data axes; seq_sp -> "model"
                           with sequence parallelism; heads_kv ->
                           "model" when K % tp == 0; kv_seq -> "model"
                           when it is not (the decode cache's fallback)

The port runs one process a rank.  On a mesh whose model axis is 1 each
process already holds only its rows of the batch, so
``shard_activation`` has nothing to do and hands the tensor back (under
the dry-run's ``launch.cost`` counter it tags the tensor with the mesh
axes its names resolve to, which the counter divides by); the
execution of specs that split a tensor over several ranks (a model axis
past 1, FSDP over a data axis past 1) waits for ROADMAP A.11d and is
refused where a step is built (``runtime.train_loop``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

from ..launch import cost

__all__ = ["PartitionSpec", "NamedSharding", "Rules", "make_rules",
           "use_rules", "current_rules", "shard_activation", "partition_params",
           "param_specs", "is_axes", "mesh_axes"]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a dimension: a mesh-axis name, a tuple of names, or
    ``None``.  ``PartitionSpec()`` is fully replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh, as the reference's ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    @property
    def shards(self) -> int:
        """Into how many pieces the spec cuts a tensor (1: replicated)."""
        n = 1
        for entry in self.spec:
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    n *= self.mesh.shape[name]
        return n


def current_rules() -> "Rules | None":
    return getattr(_state, "rules", None)


@dataclass
class Rules:
    mesh: object
    param_map: dict
    act_map: dict

    def spec(self, axes, table) -> PartitionSpec:
        return PartitionSpec(*(None if name is None else table.get(name)
                               for name in axes))

    def param_spec(self, axes) -> PartitionSpec:
        return self.spec(axes, self.param_map)

    def act_spec(self, axes) -> PartitionSpec:
        return self.spec(axes, self.act_map)

    def param_sharding(self, axes) -> NamedSharding:
        return NamedSharding(self.mesh, self.param_spec(axes))


def make_rules(mesh, *, fsdp: bool = True, seq_parallel: bool = False,
               kv_heads: int = 1, d_head: int = 128,
               overrides: dict | None = None) -> Rules:
    """The reference's default tables for ``mesh``; ``overrides`` maps a
    parameter name, or ``"act:<name>"`` for an activation, to its mesh
    axis."""
    axis_names = tuple(mesh.axis_names)
    tp = mesh.shape["model"] if "model" in axis_names else 1
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    kv_w_ok = (kv_heads * d_head) % tp == 0
    kv_a_ok = kv_heads % tp == 0

    param_map = {
        "embed": "data" if (fsdp and "data" in axis_names) else None,
        "ff": "model",
        "heads_q": "model",
        "heads_kv": "model" if kv_w_ok else None,
        "vocab": "model",
        "experts": "model",
        "mamba_inner": "model",
        "none": None,
    }
    act_map = {
        "batch": dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes
                                                   else None),
        "seq_sp": "model" if seq_parallel else None,
        "heads_q": "model",
        "heads_kv": "model" if kv_a_ok else None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "mamba_inner": "model",
        "kv_seq": None if kv_a_ok else "model",
        "none": None,
    }
    for k, v in (overrides or {}).items():
        if k.startswith("act:"):
            act_map[k[4:]] = v
        else:
            param_map[k] = v
    return Rules(mesh=mesh, param_map=param_map, act_map=act_map)


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    """Install ``rules`` for this thread (``None``: none) for the body."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def mesh_axes(spec) -> set:
    """The mesh axes a ``PartitionSpec`` names."""
    out = set()
    for entry in spec:
        out.update(e for e in (entry if isinstance(entry, tuple)
                               else (entry,)) if e is not None)
    return out


def shard_activation(x, axes):
    """Annotate an activation with logical axes: a no-op without rules;
    with rules, ``axes`` must name every dimension (``ValueError``
    otherwise, as in the reference), and ``x`` comes back as it is,
    tagged for an active ``launch.cost`` counter with the mesh axes the
    names resolve to."""
    rules = current_rules()
    if rules is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"axes {axes} vs rank {x.dim()}")
    return cost.tag(x, mesh_axes(rules.act_spec(axes)))


def is_axes(t) -> bool:
    """An axes leaf: a tuple of axis names and ``None``s."""
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


def _map_axes(fn, tree):
    if is_axes(tree):
        return fn(tree)
    return {k: _map_axes(fn, v) for k, v in tree.items()}


def partition_params(axes_tree, rules: Rules):
    """An axes tree (parallel to the parameters) mapped to each
    parameter's ``NamedSharding``."""
    return _map_axes(rules.param_sharding, axes_tree)


def param_specs(axes_tree, rules: Rules):
    return _map_axes(rules.param_spec, axes_tree)
