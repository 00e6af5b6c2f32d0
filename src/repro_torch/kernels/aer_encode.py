"""CUDA kernel of the AER event encoder (Hopper, sm_90a).

Source: ``csrc/aer_encode.cu``, built by ``_build`` into a library of its
own at first use.  Replaces ``aer_encode_pallas``
(``src/repro/kernels/aer_encode.py:67``, body ``_encode_kernel`` at
``:33``): the entries with ``|x| >= tau`` and ``x != 0`` of each
(nb, block) row, first ``budget`` in index order, compacted into event
slots ``(idx, val)`` with ``count`` and ``wanted`` per row, NaN spread
over a row that holds a non-finite entry as the reference's one-hot
contraction spreads it (``ref.aer_encode`` states the rule).

Design: a warp a row, eight rows a block, no block barrier.  The warp
takes its row in 1,024-entry tiles and issues every load of a tile
before any scan (16-byte loads: 8 a lane in float32, 4 in bfloat16);
each entry's slot comes from ballots of the mask over the lanes, and the
tile's non-finite count from one warp reduction, so the lane that holds
a selected entry writes its slot with the NaN rule applied.  Bound on an
H100: bytes — the row read once, ``budget`` 8-byte slots written: ~25 us
at (16384, 1024), budget 128.  No shared memory; registers a thread are
what ``plan`` reports.

Routes (``ROUTES``; ``plan`` says which one a call takes): ``vector``
(16-byte loads: block a multiple of 4 in float32 or 8 in bfloat16, and
``x`` 16-byte aligned), ``scalar`` (any other block, or a view whose
storage offset leaves ``x`` off a 16-byte boundary: one entry a load),
each with a ``_tiles`` form for rows of more than 1,024 entries, where
the warp loops over tiles with the count selected so far carried.

The wrapper checks its operands (CUDA, float32 or bfloat16, contiguous,
``tau`` one value a row in x's dtype, ``1 <= budget <= block <=
EVENT_MAX_BLOCK``), allocates the outputs with ``torch.empty``, launches
on PyTorch's current stream without synchronising, raises on a CUDA
error, and counts its launches (``aer_encode.launches``, bumped once per
kernel launch and nowhere else).  ``ops.aer_encode`` sends CPU tensors
to ``ref.aer_encode``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.events import EVENT_MAX_BLOCK

__all__ = ["aer_encode", "plan", "ROUTES", "VALUE_DTYPES"]

#: value dtypes the AER kernels take, with the C entry points' dtype flag
VALUE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the encoder's routes, in the order of the C enum
ROUTES = ("vector", "vector_tiles", "scalar", "scalar_tiles")
#: what ``plan`` reports, in the order of the C entry's out array
PLAN_KEYS = ("route", "registers", "static_smem", "dynamic_smem",
             "threads", "local_bytes")


def plan(x: torch.Tensor) -> dict:
    """The launch ``aer_encode`` makes for ``x`` (CUDA, (nb, block)): its
    route, registers a thread, shared memory a block (static and
    dynamic, bytes), threads a block and local (spilled) bytes a
    thread, from the C entry that picks the route."""
    lib = _build.load("aer_encode")
    out = (ctypes.c_int * len(PLAN_KEYS))()
    nb, block = x.shape
    _build.check(lib, lib.aer_encode_plan(x.data_ptr(), nb, block,
                                          VALUE_DTYPES[x.dtype], out),
                 "aer_encode plan")
    res = dict(zip(PLAN_KEYS, out))
    res["route"] = ROUTES[res["route"]]
    return res


def aer_encode(x: torch.Tensor, tau: torch.Tensor, budget: int):
    """Encode (nb, block) tiles on the card; returns ``(idx, val, count,
    wanted)``: (nb, budget) int32 and x's dtype, (nb,) int32 twice."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"aer_encode launches a CUDA kernel; got a tensor "
                         f"on {dev} (ops.aer_encode runs the plain version "
                         f"on the CPU)")
    if x.dtype not in VALUE_DTYPES:
        raise TypeError(f"aer_encode: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    _build.check_operands("aer_encode", dev, x.dtype, x=x, tau=tau)
    if x.dim() != 2:
        raise ValueError(f"aer_encode: x must be (nb, block), got "
                         f"{tuple(x.shape)}")
    nb, block = x.shape
    if tuple(tau.shape) != (nb,):
        raise ValueError(f"aer_encode: tau must be ({nb},), got "
                         f"{tuple(tau.shape)}")
    if not 1 <= block <= EVENT_MAX_BLOCK:
        raise ValueError(f"aer_encode: block {block} outside [1, "
                         f"{EVENT_MAX_BLOCK}] (16-bit event addresses)")
    if not 1 <= budget <= block:
        raise ValueError(f"aer_encode: budget {budget} outside [1, block "
                         f"= {block}]")
    idx = torch.empty((nb, budget), dtype=torch.int32, device=dev)
    val = torch.empty((nb, budget), dtype=x.dtype, device=dev)
    count = torch.empty((nb,), dtype=torch.int32, device=dev)
    wanted = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return idx, val, count, wanted
    lib = _build.load("aer_encode")
    rc = lib.aer_encode_launch(
        x.data_ptr(), tau.data_ptr(), nb, block, budget,
        VALUE_DTYPES[x.dtype], idx.data_ptr(), val.data_ptr(),
        count.data_ptr(), wanted.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "aer_encode")
    aer_encode.launches += 1
    return idx, val, count, wanted


aer_encode.launches = 0
