"""Carry state across from the JAX reference package, and results back.

The fabric simulator's data is traffic, routing and timing; the SNN and
the co-simulation add weights and a Poisson drive.  Parity tests (and
anyone migrating a workload) take the reference's arrays as numpy
arrays and hand them to :func:`from_reference` (fabric objects),
:func:`snn_params_from_reference` (``models.snn`` weights) or
:func:`cosim_weights_from_reference` (``CosimEngine(weights=)``); the
per-tick drive goes to the engines as a bool array (``drive=``).
Results come back through :func:`result_to_numpy`, so the two packages'
outputs can be compared field for field (the reference's
``network.assert_results_equal`` accepts the numpy result as is).
This module never imports the reference package: it only reads arrays.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .core.link import LinkTiming
from .core.network import FabricResult
from .core.router import RoutingTable
from .core.telemetry import Telemetry, _np
from .core.traffic import TrafficSpec
from .device import resolve_device

__all__ = ["Converted", "from_reference", "result_to_numpy",
           "snn_params_from_reference", "cosim_weights_from_reference"]


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
