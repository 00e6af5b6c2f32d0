"""Carry state across from the JAX reference package, and results back.

The fabric simulator's data is traffic, routing and timing; the SNN and
the co-simulation add weights and a Poisson drive.  Parity tests (and
anyone migrating a workload) take the reference's arrays as numpy
arrays and hand them to :func:`from_reference` (fabric objects),
:func:`snn_params_from_reference` (``models.snn`` weights) or
:func:`cosim_weights_from_reference` (``CosimEngine(weights=)``); the
per-tick drive goes to the engines as a bool array (``drive=``).
Results come back through :func:`result_to_numpy` (a batch's through
:func:`batch_result_to_numpy`), so the two packages' outputs can be
compared field for field (the reference's ``network.assert_results_equal``
accepts the numpy result, or a numpy batch's ``instance(i)``, as is);
:func:`batch_result_from_reference` carries a reference
``FabricBatchResult`` the other way, into the port's type.  The
AER payload path takes the reference's error-feedback residuals
(:func:`aer_states_from_reference`) and its event slots
(:func:`event_blocks_from_reference`), bfloat16 values included.  The
LM stack takes the reference's parameter tree
(:func:`lm_params_from_reference`), its Mamba and attention decode
caches (:func:`mamba_cache_from_reference`,
:func:`attn_cache_from_reference`) and a whole LM's cache of mixed
layers (:func:`lm_cache_from_reference`).  A training run carries over
with :func:`train_state_from_reference` (parameters, AdamW moments,
steps, and the data-parallel step's AER residuals).
This module never imports the reference package: it only reads arrays.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .core.link import LinkTiming
from .core.network import FabricBatchResult, FabricResult
from .core.router import RoutingTable
from .core.sparse_collectives import AerState, tree_map
from .core.telemetry import Telemetry, _np
from .core.traffic import TrafficSpec
from .device import resolve_device
from .kernels.ops import EventBlocks
from .models.model import LM
from .models.transformer import _kinds, n_periods, pattern_for

__all__ = ["Converted", "from_reference", "result_to_numpy",
           "batch_result_to_numpy", "batch_result_from_reference",
           "snn_params_from_reference", "cosim_weights_from_reference",
           "aer_states_from_reference", "event_blocks_from_reference",
           "lm_params_from_reference", "mamba_cache_from_reference",
           "attn_cache_from_reference", "lm_cache_from_reference",
           "train_state_from_reference", "aer_residuals_from_reference"]


class Converted(NamedTuple):
    traffic: TrafficSpec | None
    routing: RoutingTable | None
    timing: LinkTiming | None


def _i32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.size and (a.min() < np.iinfo(np.int32).min
                   or a.max() > np.iinfo(np.int32).max):
        raise ValueError("value out of int32 range")
    return np.ascontiguousarray(a, np.int32)


def from_reference(*, traffic=None, routing=None,
                   timing: Mapping | None = None) -> Converted:
    """Build the port's objects from the reference's numpy arrays.

    ``traffic``: ``(src, t, dest)`` — a ``TrafficSpec``'s fields, made
    int32 tensors on the CPU (the planner reads traffic on the host).
    ``routing``: ``(next_link, out_side, hops)`` — a ``RoutingTable``.
    ``timing``: a mapping of ``LinkTiming`` field names to scalars or
    (L,) arrays (e.g. ``dataclasses.asdict`` of the reference's).
    Omitted parts come back as ``None``.
    """
    spec = None
    if traffic is not None:
        src, t, dest = (torch.from_numpy(_i32(a)) for a in traffic)
        if not (src.shape == t.shape == dest.shape) or src.dim() != 1:
            raise ValueError("traffic arrays must be three (E,) arrays")
        spec = TrafficSpec(src=src, t=t, dest=dest)
    rt = None
    if routing is not None:
        nl, os_, hops = (_i32(a) for a in routing)
        rt = RoutingTable(next_link=nl, out_side=os_, hops=hops)
    lt = None
    if timing is not None:
        lt = LinkTiming(**{k: (np.asarray(v) if np.ndim(v) else v)
                           for k, v in timing.items()})
    return Converted(traffic=spec, routing=rt, timing=lt)


def result_to_numpy(res: FabricResult) -> FabricResult:
    """The same result with every tensor (telemetry included) copied to
    a host numpy array; dtypes are kept (int32 throughout)."""
    tel = res.telemetry
    return res._replace(
        **{f: _np(getattr(res, f)) for f in res._fields
           if torch.is_tensor(getattr(res, f))},
        telemetry=None if tel is None else Telemetry(*map(_np, tel)))


def batch_result_to_numpy(batch: FabricBatchResult) -> FabricBatchResult:
    """The same batch result with every tensor (telemetry included) as a
    host numpy array, dtypes kept; ``instance(i)`` of it is a numpy
    ``FabricResult`` the reference's ``assert_results_equal`` takes."""
    return batch._replace(
        **{f: _np(getattr(batch, f)) for f in batch._fields
           if torch.is_tensor(getattr(batch, f))},
        telemetry=Telemetry(*map(_np, batch.telemetry)))


def batch_result_from_reference(batch) -> FabricBatchResult:
    """A reference ``FabricBatchResult`` (JAX or numpy arrays) as the
    port's, with CPU tensors (int32 kept) and numpy ``injected`` /
    ``offered``; compare it with the port's own results by
    ``network.assert_results_equal`` on ``instance(i)``."""
    def t(a):
        return torch.from_numpy(np.array(a))

    return FabricBatchResult(
        **{f: t(getattr(batch, f)) for f in FabricBatchResult._fields
           if f not in ("injected", "offered", "telemetry")},
        injected=np.asarray(batch.injected, np.int64),
        offered=np.asarray(batch.offered, np.int64),
        telemetry=Telemetry(*(t(getattr(batch.telemetry, f))
                              for f in Telemetry._fields)))


def _f32(a, ndim: int, what: str) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim != ndim or not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"{what} must be a {ndim}-d float array, got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(np.array(a, np.float32))   # a writable copy


def snn_params_from_reference(params: Mapping, *,
                              device=None) -> dict:
    """``models.snn`` weights from the reference's ``{"w_rec", "w_in"}``
    (each (R, C, n, n)), as float32 tensors on ``device`` (``None``: the
    CUDA card)."""
    dev = resolve_device(device)
    out = {k: _f32(params[k], 4, k).to(dev) for k in ("w_rec", "w_in")}
    if out["w_rec"].shape != out["w_in"].shape:
        raise ValueError("w_rec and w_in must share one (R, C, n, n) shape")
    return out


def cosim_weights_from_reference(w) -> torch.Tensor:
    """``CosimEngine(weights=)`` from the reference engine's projection
    weights (its ``_w_np``, (n_proj, n, n)): a float32 CPU tensor (the
    engine moves it to its device)."""
    return _f32(w, 3, "cosim weights")


def _tensor(a) -> torch.Tensor:
    """A writable CPU tensor of the numpy array ``a``, dtype kept;
    bfloat16 arrays (numpy's ``ml_dtypes`` type, which torch cannot
    read) travel as their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def aer_states_from_reference(residuals, *, device=None):
    """``AerState`` tree from the reference's residuals: a nested dict of
    arrays (or of the reference's ``AerState``s, whose one field is the
    residual) -> the same tree of ``AerState`` on ``device`` (``None``:
    the CUDA card)."""
    dev = resolve_device(device)

    def one(r):
        r = getattr(r, "residual", r)
        return AerState(residual=_tensor(r).to(dev))

    return tree_map(one, residuals)


def event_blocks_from_reference(events, *, device=None) -> EventBlocks:
    """``EventBlocks`` from the reference's ``(idx, val, count, wanted)``
    arrays (its ``EventBlocks`` or any 4-sequence), on ``device``."""
    dev = resolve_device(device)
    idx, val, count, wanted = (_tensor(a) for a in events)
    for name, t in (("idx", idx), ("count", count), ("wanted", wanted)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    return EventBlocks(idx.to(dev), val.to(dev), count.to(dev),
                       wanted.to(dev))


def _leaves(tree: Mapping, prefix: str = ""):
    """``(dotted path, leaf)`` of a nested dict, in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _lm_leaves(tree: Mapping, cfg) -> dict:
    """The reference LM's parameter-shaped tree (its params, or an
    optimiser moment of them) by the port's parameter names: top-level
    leaves by name, each stacked leaf ``stack/pos<i>/<path>[p]`` as
    ``stack.blocks.<p·len(pattern) + i>.<path>``."""
    out = {f"{top}.{path}": leaf for top in tree if top != "stack"
           for path, leaf in _leaves(tree[top])}
    pat = pattern_for(cfg)
    for i in range(len(pat)):
        for path, leaf in _leaves(tree["stack"][f"pos{i}"]):
            for p in range(n_periods(cfg)):
                out[f"stack.blocks.{p * len(pat) + i}.{path}"] = leaf[p]
    return out


def lm_params_from_reference(params: Mapping, cfg, *, device=None) -> LM:
    """An ``LM`` holding the reference LM's parameters (its ``init``
    tree, as numpy or JAX arrays) on ``device`` (``None``: the CUDA
    card).  The top-level leaves carry over by name (``embed.table``,
    ``frontend.w``, ``ln_f.scale``, ``head.w``; a tied model has no
    ``head``, an audio model no ``embed``); each stacked leaf
    ``stack/pos<i>/<path>[p]`` goes to layer ``p·len(pattern) + i`` as
    ``stack.blocks.<layer>.<path>`` (a cross-attention block's scalar
    ``xgate`` included).  Every parameter must be given, in the port's
    shape and dtype."""
    model = LM(cfg, device=device)
    state = _lm_leaves(params, cfg)
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    for name, leaf in state.items():
        t = _tensor(leaf)
        if t.shape != own[name].shape or t.dtype != own[name].dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, the "
                             f"port holds {own[name].dtype} "
                             f"{tuple(own[name].shape)}")
        state[name] = t
    model.load_state_dict(state, strict=True)
    return model


def mamba_cache_from_reference(cache: Mapping, *, device=None):
    """A Mamba decode cache from the reference's ``{"h", "conv"}``
    (h (B, d_in, N), conv (B, d_conv-1, d_in), float32) on ``device``
    (``None``: the CUDA card).  The reference LM's cache stacks one such
    cache over layers (``cache["pos0"]``, h (L, B, d_in, N)); that gives
    the port's list of one cache a layer."""
    dev = resolve_device(device)
    h = _f32(cache["h"], np.ndim(cache["h"]), "h")
    conv = _f32(cache["conv"], h.dim(), "conv")
    if h.dim() == 4:
        return [{"h": h[i].to(dev), "conv": conv[i].to(dev)}
                for i in range(h.shape[0])]
    if h.dim() != 3:
        raise ValueError(f"h must be (B, d_in, N) or stacked over layers, "
                         f"got {tuple(h.shape)}")
    return {"h": h.to(dev), "conv": conv.to(dev)}


def attn_cache_from_reference(cache: Mapping, *, device=None):
    """An attention decode cache from the reference's ``{"k", "v"}`` (B,
    S, K, dh), with ``"slot_pos"`` (B, W) int32 for a ring, on ``device``
    (``None``: the CUDA card), dtypes kept (bfloat16 included).  Stacked
    over periods (k (P, B, S, K, dh), as the reference LM's
    ``cache["pos<i>"]``), it gives a list of one cache a period."""
    dev = resolve_device(device)
    if set(cache) - {"k", "v", "slot_pos"} or not {"k", "v"} <= set(cache):
        raise ValueError(f"an attention cache holds k, v and, for a ring, "
                         f"slot_pos; got {sorted(cache)}")
    t = {name: _tensor(leaf) for name, leaf in cache.items()}
    if t["k"].dim() not in (4, 5) or t["v"].shape != t["k"].shape:
        raise ValueError(f"k and v must share a (B, S, K, dh) shape or be "
                         f"stacked over periods, got {tuple(t['k'].shape)} "
                         f"and {tuple(t['v'].shape)}")
    if "slot_pos" in t and t["slot_pos"].dtype != torch.int32:
        raise ValueError(f"slot_pos must be int32, got {t['slot_pos'].dtype}")
    if t["k"].dim() == 5:
        return [{name: leaf[p].to(dev) for name, leaf in t.items()}
                for p in range(t["k"].shape[0])]
    return {name: leaf.to(dev) for name, leaf in t.items()}


def lm_cache_from_reference(cache: Mapping, cfg, *, device=None) -> list:
    """The port's LM decode cache (one dict a layer) from the reference
    LM's (``{"pos<i>": cache stacked over periods}``): layer
    ``p·len(pattern) + i`` gets period ``p`` of ``pos<i>``, a Mamba cache
    for a ``mamba*`` block, else an attention cache (a cross-attention
    block's image ``{"k", "v"}`` included)."""
    pat = pattern_for(cfg)
    per_pos = [mamba_cache_from_reference(cache[f"pos{i}"], device=device)
               if kind.startswith("mamba") else
               attn_cache_from_reference(cache[f"pos{i}"], device=device)
               for i, kind in enumerate(pat)]
    kinds = _kinds(cfg)
    return [per_pos[layer % len(pat)][layer // len(pat)]
            for layer in range(len(kinds))]


def train_state_from_reference(state, cfg, *, device=None):
    """``(model, TrainState)`` from the reference's ``TrainState``
    (``params``, ``opt`` = ``AdamWState(step, mu, nu)``, ``aer``,
    ``step``; JAX or numpy leaves) on ``device`` (``None``: the CUDA
    card): the parameters through :func:`lm_params_from_reference`, with
    gradients enabled, and ``mu``, ``nu`` by the same stacked-to-block
    mapping, float32; any AER residuals as the data-parallel step keeps
    them (:func:`aer_residuals_from_reference`); the two step counters as
    int32 host scalars.  The state's ``params`` are the model's own, as
    ``runtime.train_loop.init_state`` makes them."""
    from .optim.adamw import AdamWState
    from .runtime.train_loop import TrainState
    model = lm_params_from_reference(state.params, cfg, device=device)
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def moments(tree):
        leaves = _lm_leaves(tree, cfg)
        if set(leaves) != set(params):
            raise ValueError(f"moment names differ from the parameters': "
                             f"{sorted(set(leaves) ^ set(params))}")
        return {k: _tensor(leaves[k]).to(params[k].device) for k in params}

    def step_of(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32)

    opt = AdamWState(step=step_of(state.opt.step), mu=moments(state.opt.mu),
                     nu=moments(state.opt.nu))
    aer = None
    if state.aer is not None:
        aer = aer_residuals_from_reference(state.aer, cfg, model)
    return model, TrainState(params=params, opt=opt, aer=aer,
                             step=step_of(state.step))


def aer_residuals_from_reference(aer, cfg, model) -> dict:
    """The trainer's ``aer_topk`` residuals (``TrainState.aer``) from the
    reference's (its tree of ``AerState`` or of arrays, one a parameter
    leaf): keyed as ``runtime.train_loop.ReferenceLeaves`` keys them,
    ``stack.pos<i>.<path>`` kept stacked over periods as the reference
    holds it, on ``model``'s device."""
    from .core.sparse_collectives import AerState
    from .runtime.train_loop import ReferenceLeaves
    res = _map_leaves(lambda a: getattr(a, "residual", a), aer)
    flat = {f"{top}.{path}": leaf for top in res if top != "stack"
            for path, leaf in _leaves(res[top])}
    for pos, tree in res.get("stack", {}).items():
        flat.update((f"stack.{pos}.{path}", leaf)
                    for path, leaf in _leaves(tree))
    keys = ReferenceLeaves(model).members.keys()
    if set(flat) != set(keys):
        raise ValueError(f"residual leaves differ from the model's: "
                         f"{sorted(set(flat) ^ set(keys))}")
    return {k: AerState(residual=_tensor(flat[k]).to(model.device))
            for k in sorted(keys)}


def _map_leaves(fn, tree):
    """``fn`` over the leaves of nested dicts (a leaf may be a NamedTuple,
    as the reference's ``AerState``)."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)
