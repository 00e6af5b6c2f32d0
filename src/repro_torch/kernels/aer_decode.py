"""CUDA kernel of the AER event decoder (Hopper, sm_90a).

Source: ``csrc/aer_decode.cu``, built by ``_build`` into a library of its
own at first use.  Replaces ``aer_decode_pallas``
(``src/repro/kernels/aer_decode.py:39``, body ``_decode_kernel`` at
``:22``): ``dense[r, b] = sum of val[r, e] over idx[r, e] == b``, void
slots (idx < 0 or >= block) addressing nothing, sums in float32 from +0
in slot order, rounded once to val's dtype, NaN spread over a row as the
reference's one-hot contraction spreads it (``ref.aer_decode`` states
the rule).

Design: a warp a row, up to eight rows a block, no block barrier.  Each
warp accumulates its row in float32 in shared memory (4 KB at block
1024), loads its slots up front (lane l holds slot 32k + l: 4 idx and 4
val a lane at budget 128), takes the row's non-finite count and the
lowest and highest address they go to by warp reductions, and adds
chunk by chunk: lanes that share an address are grouped with
``__match_any_sync``; a lane alone at its address adds its own value,
and a group's lowest lane adds the group in slot order from values
staged in shared memory, so duplicates give the same bits on every run.
The row then goes out with 16-byte stores.  No atomics.  Bound on an
H100: bytes — ``budget`` 8-byte slots read and the dense row written:
~25 us at (16384, 1024), budget 128.

Routes (``ROUTES``; ``plan`` says which one a call takes), by a warp's
shared memory, 4 · (roundup(block, 4) + 32) bytes: ``warp`` within the
48 KB default (up to 8 warps a block; block <= 12,256), ``warp_optin``
within the card's opt-in limit (one warp a block; block <= 58,080 on an
H100), and ``global`` past it, where a block of 256 threads a row
accumulates in global memory: the output row itself in float32, a
float32 scratch row that this wrapper allocates in bfloat16.

The wrapper checks its operands (CUDA, idx int32 and val float32 or
bfloat16 of one (nb, budget) shape, contiguous, ``block >= 1``),
allocates the output with ``torch.empty``, launches on PyTorch's current
stream without synchronising, raises on a CUDA error, and counts its
launches (``aer_decode.launches``).  ``ops.aer_decode`` sends CPU
tensors to ``ref.aer_decode``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aer_encode import PLAN_KEYS, VALUE_DTYPES

__all__ = ["aer_decode", "plan", "ROUTES"]

#: the decoder's routes, in the order of the C enum
ROUTES = ("warp", "warp_optin", "global")


def plan(block: int, dtype: torch.dtype = torch.float32) -> dict:
    """The launch ``aer_decode`` makes for rows of ``block`` addresses in
    ``dtype``: its route, registers a thread, shared memory a block
    (static and dynamic, bytes), threads a block and local (spilled)
    bytes a thread, from the C entry that picks the route."""
    lib = _build.load("aer_decode")
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _build.check(lib, lib.aer_decode_plan(block, VALUE_DTYPES[dtype], out),
                 "aer_decode plan")
    res = dict(zip(PLAN_KEYS, out))
    res["route"] = ROUTES[res["route"]]
    return res


def aer_decode(idx: torch.Tensor, val: torch.Tensor, block: int):
    """Decode (nb, budget) event slots on the card into (nb, block) of
    val's dtype."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"aer_decode launches a CUDA kernel; got a tensor "
                         f"on {dev} (ops.aer_decode runs the plain version "
                         f"on the CPU)")
    if val.dtype not in VALUE_DTYPES:
        raise TypeError(f"aer_decode: val must be float32 or bfloat16, got "
                        f"{val.dtype}")
    _build.check_operands("aer_decode", dev, torch.int32, idx=idx)
    _build.check_operands("aer_decode", dev, val.dtype, val=val)
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(f"aer_decode: idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must share one (nb, budget) "
                         f"shape")
    if block < 1:
        raise ValueError(f"aer_decode: block must be >= 1, got {block}")
    nb, budget = idx.shape
    out = torch.empty((nb, block), dtype=val.dtype, device=dev)
    if nb == 0:
        return out
    lib = _build.load("aer_decode")
    scratch = None
    if val.dtype != torch.float32 and plan(block, val.dtype)["route"] \
            == "global":
        scratch = torch.empty((nb, block), dtype=torch.float32, device=dev)
    rc = lib.aer_decode_launch(
        idx.data_ptr(), val.data_ptr(), nb, budget, block,
        VALUE_DTYPES[val.dtype], out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "aer_decode")
    aer_decode.launches += 1
    return out


aer_decode.launches = 0
