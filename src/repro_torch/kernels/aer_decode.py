"""CUDA kernel of the AER event decoder (Hopper, sm_90a).

Source: ``csrc/aer_decode.cu``, built by ``_build`` into a library of its
own at first use.  Replaces ``aer_decode_pallas``
(``src/repro/kernels/aer_decode.py:39``, body ``_decode_kernel`` at
``:22``): ``dense[r, b] = sum of val[r, e] over idx[r, e] == b``, void
slots (idx < 0 or >= block) addressing nothing, sums in float32 rounded
once to val's dtype, NaN spread over a row as the reference's one-hot
contraction spreads it (``ref.aer_decode`` states the rule).

Design: one thread block per row.  The float32 row accumulates in shared
memory while it fits the card's limit (past it, in global memory: the
output row itself for float32, a float32 scratch row for bfloat16, which
this wrapper allocates); one warp adds the slots 32 at a time, lanes
that share an address grouped with ``__match_any_sync`` and added in
slot order, so duplicates give the same bits on every run; the block
then writes the row once.  No atomics.  Bound on an H100: bytes —
``budget`` 8-byte slots read and the dense row written: ~25 us at
(16384, 1024), budget 128.

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
from .aer_encode import VALUE_DTYPES

__all__ = ["aer_decode"]


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
    if val.dtype != torch.float32:
        fits = ctypes.c_int(0)
        _build.check(lib, lib.aer_decode_fits_shared(block,
                                                     ctypes.byref(fits)),
                     "aer_decode")
        if not fits.value:
            scratch = torch.empty((nb, block), dtype=torch.float32,
                                  device=dev)
    rc = lib.aer_decode_launch(
        idx.data_ptr(), val.data_ptr(), nb, budget, block,
        VALUE_DTYPES[val.dtype], out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "aer_decode")
    aer_decode.launches += 1
    return out


aer_decode.launches = 0
