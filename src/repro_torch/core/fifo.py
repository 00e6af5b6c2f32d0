"""Bounded functional FIFO — the TX/RX FIFOs of Fig. 1.

The PyTorch counterpart of the reference ``core/fifo.py``.  A FIFO is a
``(buffer, head, count)`` triple of tensors handled by pure functions:
each returns a new ``Fifo`` and never writes into its argument, so an
old state stays valid (the reference's arrays are immutable).  Overflow
pushes are dropped and reported (the hardware analogue: the 4-phase
handshake would stall upstream; the protocol simulator uses the
reported flag to model back-pressure).  ``head`` and ``count`` are 0-d
int32 tensors and the flags 0-d bool tensors, so nothing here reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["Fifo", "make_fifo", "fifo_push", "fifo_pop", "fifo_peek",
           "fifo_empty", "fifo_full"]


class Fifo(NamedTuple):
    buf: torch.Tensor    # (capacity,) any dtype
    head: torch.Tensor   # 0-d int32 — index of the oldest element
    count: torch.Tensor  # 0-d int32 — number of valid elements

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]


def make_fifo(capacity: int, dtype=torch.int64, device=None) -> Fifo:
    """An empty FIFO of ``capacity`` slots.  The default dtype holds the
    reference's uint32 words by value (int64, as ``events``' payload
    words); ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return Fifo(buf=torch.zeros((capacity,), dtype=dtype, device=dev),
                head=torch.zeros((), dtype=torch.int32, device=dev),
                count=torch.zeros((), dtype=torch.int32, device=dev))


def _flag(enable, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(enable, dtype=torch.bool, device=like.device)


def fifo_push(f: Fifo, value, enable=True):
    """Push ``value`` if ``enable`` and not full.  Returns ``(fifo, ok)``."""
    ok = _flag(enable, f.count) & (f.count < f.capacity)
    slot = ((f.head + f.count) % f.capacity).long()
    val = torch.as_tensor(value, device=f.buf.device).to(f.buf.dtype)
    buf = f.buf.clone()
    buf[slot] = torch.where(ok, val, f.buf[slot])
    return Fifo(buf, f.head, f.count + ok.to(torch.int32)), ok


def fifo_pop(f: Fifo, enable=True):
    """Pop the oldest element if ``enable`` and non-empty.

    Returns ``(fifo, value, ok)``; ``value`` is unspecified when not ok
    (it is the slot at ``head``, as in the reference).
    """
    ok = _flag(enable, f.count) & (f.count > 0)
    value = f.buf[f.head.long()]
    head = torch.where(ok, (f.head + 1) % f.capacity, f.head)
    return Fifo(f.buf, head, f.count - ok.to(torch.int32)), value, ok


def fifo_peek(f: Fifo):
    """``(value_at_head, non_empty)``."""
    return f.buf[f.head.long()], f.count > 0


def fifo_empty(f: Fifo):
    return f.count == 0


def fifo_full(f: Fifo):
    return f.count >= f.capacity
