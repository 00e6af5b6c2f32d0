"""Tensor, expert and fully-sharded data parallelism of the port's LM
over a ``(data, model)`` mesh of ranks, one process a rank.

The reference shards its parameters by ``make_rules``' specs and lets
GSPMD insert the collectives.  The port cuts each parameter into this
rank's shard by the same specs (``shard_model``) and runs the
collectives itself:

- **FSDP** (a dimension over ``"data"``): a block gathers its leaves
  over the data group before it runs (``Parallel.fsdp`` /
  ``Parallel.view``, an all-gather whose backward reduce-scatters the
  gradient, so each rank's shard receives the sum over the data group);
  under ``cfg.remat`` the gather sits inside the checkpointed function,
  so the recompute gathers again and no gathered weight outlives its
  block.
- **The model axis**: Megatron's conjugate pair, *f*
  (``Parallel.copy``: identity forward, all-reduce of the gradient
  backward) where a whole activation enters a split computation, and
  *g* (``Parallel.reduce``: all-reduce forward, identity backward)
  where the partial sums of a split computation leave it.  A whole
  parameter used by a split computation (a qk-norm scale, a key/value
  weight the rules keep whole) goes through *f* too, so its gradient
  is the whole sum on every rank.  ``Parallel.gather`` is an all-gather
  over the model group whose backward reduce-scatters (the keys and
  values when the kv heads do not split over the model axis but their
  weights do).

A dimension may hold interleaved groups (``sharding.Axes``): each rank's
shard of Mamba's ``in_proj`` is its block of ``x``'s channels followed by
the same block of ``z``'s.  ``shard_param`` and ``unshard_param`` cut and
rebuild a whole leaf in the reference's layout either way, so
checkpoints and the interop hold whole leaves.

Serving and scoring run on the same shards (``models.model.LM``'s
``prefill``, ``decode_step`` and ``score``): the batch's rows split over
the data group as the reference's ``_batch_axis`` splits them (when the
data group divides the rows), and each rank's decode cache is its part
of the reference's ``_cache_shardings``: the key/value heads over the
model group (``heads_kv``), or, when they do not split, the cache's
slots (``kv_seq``: a contiguous block of ``ceil(slots / tp)`` a rank,
the last one padded), and a Mamba layer's state over its channels.
Over a sequence-split cache a decode step combines each rank's partial
softmax over the model group in float32 (``Parallel.max``,
``Parallel.total`` and ``Parallel.scatter``: a maximum, a sum, then a
reduce-scatter of the weighted values to each rank's query heads).
``Parallel.kv_cache`` names the layout; ``Parallel.rows`` and
``Parallel.whole_rows`` cut and rejoin the batch's rows.

A collective over a group of one rank is skipped: a mesh whose model
axis is 1 and whose parameters no spec splits runs the data-parallel
step exactly as it ran before.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from .compat import (DP_AXES, Mesh, all_gather_dim, all_reduce, axis_index,
                     axis_size, reduce_scatter)
from .sharding import NamedSharding

__all__ = ["Split", "Parallel", "shard_param", "unshard_param", "whole_shape",
           "shard_model", "unshard_params"]

#: the attribute of a sharded model's parameter holding its ``Split``
SPLIT_ATTR = "_mesh_split"


def _names(entry) -> tuple:
    return tuple(e for e in (entry if isinstance(entry, tuple) else (entry,))
                 if e is not None)


def _axis_kind(entry, mesh: Mesh):
    """``"dp"`` when a spec entry splits over the data axes, ``"tp"``
    over the others, ``None`` when its axes have one rank."""
    names = _names(entry)
    if math.prod(mesh.shape[a] for a in names) == 1:
        return None
    on_dp = {a in DP_AXES for a in names if mesh.shape[a] > 1}
    if len(on_dp) != 1:
        raise ValueError(f"spec entry {entry!r} mixes data and model axes")
    dp_axes = {a for a in DP_AXES if mesh.shape.get(a, 1) > 1}
    if on_dp == {True} and {a for a in names if mesh.shape[a] > 1} \
            != dp_axes:
        raise ValueError(f"spec entry {entry!r} splits over part of the "
                         f"data axes {sorted(dp_axes)}; the data group "
                         f"spans all of them")
    return "dp" if on_dp == {True} else "tp"


class Split(NamedTuple):
    """How one parameter lies over the mesh: its sharding, the whole
    leaf's shape, and the dimensions split over the data axes (FSDP)
    and over the model axis (``None``: not split)."""
    sharding: NamedSharding
    full: tuple
    dp_dim: int | None
    tp_dim: int | None

    @classmethod
    def of(cls, sharding: NamedSharding, full) -> "Split":
        dims = {"dp": None, "tp": None}
        for d, entry in enumerate(sharding.spec):
            kind = _axis_kind(entry, sharding.mesh)
            if kind is not None:
                if dims[kind] is not None:
                    raise ValueError(f"spec {tuple(sharding.spec)} splits "
                                     f"two dimensions over one axis")
                dims[kind] = d
        return cls(sharding, tuple(full), dims["dp"], dims["tp"])

    @property
    def split(self) -> bool:
        return self.dp_dim is not None or self.tp_dim is not None


def _index(entry, mesh: Mesh, coords: dict):
    """``(pieces, this rank's piece)`` of a spec entry."""
    names = _names(entry)
    n, i = 1, 0
    for a in names:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
    return n, i


def shard_param(full: torch.Tensor, spec, mesh: Mesh, rank: int,
                groups=None) -> torch.Tensor:
    """Global rank ``rank``'s shard of the whole leaf ``full`` under
    ``spec`` over ``mesh`` (a new tensor; ``full`` itself when nothing
    splits it).  A dimension of ``groups[d]`` > 1 interleaved groups is
    cut group by group: the shard holds the rank's block of each."""
    coords = mesh.coords(rank)
    out = full
    for d, entry in enumerate(spec):
        n, i = _index(entry, mesh, coords)
        if n == 1:
            continue
        g = groups[d] if groups else 1
        size = out.shape[d]
        if size % (n * g):
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does "
                             f"not split into {n} x {g} blocks")
        out = out.unflatten(d, (g, n, size // (g * n))).select(d + 1, i) \
            .flatten(d, d + 1)
    return full if out is full else out.clone(
        memory_format=torch.contiguous_format)


def whole_shape(shape, sharding: NamedSharding) -> tuple:
    """The whole leaf's shape from a shard's ``shape``."""
    return tuple(n * math.prod(sharding.mesh.shape[a] for a in _names(e))
                 for n, e in zip(shape, sharding.spec))


def _group_of(kind: str, mesh: Mesh):
    return mesh.dp_group if kind == "dp" else mesh.model_group


def unshard_param(local: torch.Tensor, sharding: NamedSharding,
                  full_shape) -> torch.Tensor:
    """The whole leaf from every rank's ``local`` shard (a collective
    over the groups of ``sharding.mesh``: every rank of the mesh calls
    it): each dimension shorter than ``full_shape``'s is gathered over
    its group, interleaved groups put back in place.  ``local`` itself
    when it is whole."""
    out = local
    for d, entry in enumerate(sharding.spec):
        if out.shape[d] == full_shape[d]:
            continue
        kind = _axis_kind(entry, sharding.mesh)
        group = _group_of(kind, sharding.mesh)
        n = axis_size(group)
        g = sharding.groups[d] if sharding.groups else 1
        out = all_gather_dim(out, d, group)
        if g > 1:
            c = out.shape[d] // (n * g)
            out = out.unflatten(d, (n, g, c)).transpose(d, d + 1) \
                .flatten(d, d + 2)
    return out


# --- autograd-aware collectives ------------------------------------------

def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over ``group``, added in float32
    for a half-precision ``t`` and rounded once."""
    out = t.float() if t.dtype in (torch.bfloat16, torch.float16) \
        else t.clone()
    all_reduce(out, group)
    return out.to(t.dtype)


class _Copy(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter (sum) backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


# --- the context a sharded model runs under --------------------------------

def _on_model(entry, mesh: Mesh) -> bool:
    """Whether an activation rule's entry splits over the model axis."""
    return any(a not in DP_AXES and mesh.shape.get(a, 1) > 1
               for a in _names(entry))


class Parallel:
    """A sharded model's place on its mesh: the model-axis group
    (``model``, ``tp`` ranks, this one ``tp_rank``), the data-parallel
    group (``data``, ``dp``, ``dp_rank``), each parameter's ``Split`` by
    name, and what the rules' activation table (``act_map``) says of
    serving: whether the batch's rows split over the data group
    (``rows_split``) and how a decode cache lies over the model group
    (``kv_cache``: ``"heads"``, its key/value heads split; ``"seq"``,
    its slots split; ``None``, whole).  Its methods are the model code's
    collectives; over a group of one rank they hand their input
    back."""

    def __init__(self, mesh: Mesh, rank: int, splits: dict,
                 act_map: dict):
        self.mesh, self.rank, self.splits = mesh, rank, splits
        self.model, self.data = mesh.model_group, mesh.dp_group
        self.tp, self.tp_rank = axis_size(self.model), axis_index(self.model)
        self.dp, self.dp_rank = axis_size(self.data), axis_index(self.data)
        self.act_map = dict(act_map)
        self.rows_split = self.dp > 1 and act_map.get("batch") is not None
        heads, seq = (_on_model(act_map.get(n), mesh)
                      for n in ("heads_kv", "kv_seq"))
        if heads and seq:
            raise ValueError("the rules split the decode cache over its "
                             "kv heads and its slots at once")
        self.kv_cache = "heads" if heads else "seq" if seq else None

    def pieces(self, name: str) -> int:
        """The model-axis pieces the activation axis ``name`` splits
        into (1: whole on every rank)."""
        return self.tp if _on_model(self.act_map.get(name), self.mesh) \
            else 1

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: its data
        coordinate's block when the data group divides ``n`` (the
        reference's ``_batch_axis``), else all of them."""
        if not self.rows_split or n % self.dp:
            return slice(0, n)
        m = n // self.dp
        return slice(self.dp_rank * m, (self.dp_rank + 1) * m)

    def whole_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The global batch of ``n`` rows from this rank's ``x`` (rows
        along dimension 0; no gradient): gathered over the data group
        where ``rows`` split them."""
        if x.shape[0] == n:
            return x
        return all_gather_dim(x.detach(), 0, self.data)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.model) if self.tp > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.model) if self.tp > 1 else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim, self.model) if self.tp > 1 else x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over the model group (no gradient)."""
        if self.tp == 1:
            return x.detach()
        out = x.detach().clone()
        all_reduce(out, self.model, op="max")
        return out

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group (no gradient), in ``x``'s
        dtype."""
        return x.detach() if self.tp == 1 else _sum_over(x.detach(),
                                                         self.model)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the model group, cut into ``tp`` blocks along
        ``dim``: this rank's block (no gradient)."""
        if self.tp == 1:
            return x.detach()
        return reduce_scatter(x.detach(), dim, self.model)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data group (no gradient)."""
        out = x.detach().clone()
        all_reduce(out, self.data)
        return out / self.dp

    def fsdp(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` gathered over the data group along its FSDP dimension
        (``p`` itself when no spec splits it over data, or when it is
        already whole there, as in the manual modes' step)."""
        split = getattr(p, SPLIT_ATTR, None)
        if split is None or split.dp_dim is None:
            return p
        d = split.dp_dim
        if p.shape[d] == split.full[d]:
            return p
        return _Gather.apply(p, d, self.data)

    def view(self, module: nn.Module):
        """``module``, or a namespace mirroring its attributes with every
        FSDP leaf gathered (``fsdp``): what a block reads its weights
        from inside its checkpointed function."""
        gathered = {n: self.fsdp(p)
                    for n, p in module.named_parameters(recurse=False)}
        kids = {n: self.view(m) for n, m in module.named_children()}
        if all(gathered[n] is p for n, p in
               module.named_parameters(recurse=False)) and \
                all(kids[n] is m for n, m in module.named_children()):
            return module
        ns = types.SimpleNamespace(**gathered, **kids)
        if hasattr(module, "kind"):
            ns.kind = module.kind
        return ns


def _owner(model: nn.Module, name: str):
    *path, attr = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, attr


def shard_model(model: nn.Module, rules):
    """Cut ``model``'s parameters (an ``LM`` holding whole leaves, the
    same on every rank) to this process's shards by ``rules``' specs, in
    place: each split parameter becomes a new ``nn.Parameter`` of the
    shard's shape, and every parameter carries its ``Split``.  Sets and
    returns ``model.parallel``.  A model already cut by the same rules
    is left as it is; by others, refused."""
    mesh = rules.mesh
    axes = model.param_axes()
    par = getattr(model, "parallel", None)
    if par is not None:
        if any(par.splits[n].sharding != rules.param_sharding(axes[n])
               for n in axes):
            raise ValueError("the model is already sharded by other rules; "
                             "build it anew to shard it again")
        return par
    if mesh.groups is None:
        raise ValueError("the rules' mesh has no process groups (an "
                         "abstract mesh): build it with make_host_mesh")
    rank = dist.get_rank()
    splits = {}
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            sh = rules.param_sharding(axes[name])
            split = Split.of(sh, p.shape)
            if split.split:
                local = shard_param(p.detach(), sh.spec, mesh, rank,
                                    sh.groups)
                mod, attr = _owner(model, name)
                p = nn.Parameter(local, requires_grad=p.requires_grad)
                setattr(mod, attr, p)
            setattr(p, SPLIT_ATTR, split)
            splits[name] = split
    model.parallel = Parallel(mesh, rank, splits, rules.act_map)
    return model.parallel


def unshard_params(model: nn.Module) -> dict:
    """Every parameter of a sharded model, whole (a collective: every
    rank of its mesh calls it), by name."""
    par = model.parallel
    return {n: unshard_param(p.detach(), par.splits[n].sharding,
                             par.splits[n].full)
            for n, p in model.named_parameters()}
