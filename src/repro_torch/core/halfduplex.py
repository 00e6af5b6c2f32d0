"""Half-duplex / bidirectional ring collectives (paper technique, layer 2).

The PyTorch counterpart of the reference ``core/halfduplex.py``.  The
paper's transceiver shares ONE physical bus between two directions and
switches on demand; a reversal costs ~4 ns against a 31 ns event cycle,
so keeping a link busy in both directions is nearly free.  A
*unidirectional* ring schedule drives each link in one direction only;
``bidirectional=True`` splits every payload in half and runs two
counter-rotating rings, so both directions of every link carry traffic.

Every rank of the process group calls these with a tensor of one shape.
The reference's ``jax.lax.ppermute`` over the ring becomes one
``parallel.compat.ppermute`` a hop (a ``dist.batch_isend_irecv``: send
to the next rank, receive from the previous one, or the other way
round; on an abstract mesh's ``RecordingGroup`` it is only recorded),
with the reference's chunk
order, so each rank adds the same values in the same order as the
reference's device of that index.  All variants equal an all-reduce sum
(tested with 8 gloo ranks on the CPU).
"""

from __future__ import annotations

import torch

from ..parallel.compat import axis_index, axis_size, ppermute

__all__ = ["ring_reduce_scatter", "ring_all_gather", "ring_allreduce",
           "wire_bytes_per_direction"]


def _ppermute(t: torch.Tensor, group, reverse: bool) -> torch.Tensor:
    """Shift ``t`` one hop round the ring: rank i sends to i + 1 (i - 1
    when ``reverse``) and returns what it received from i - 1 (i + 1)."""
    n, i = axis_size(group), axis_index(group)
    step = -1 if reverse else 1
    out = torch.empty_like(t)
    ppermute(t, out, (i + step) % n, (i - step) % n, group)
    return out


def _pad_to(x: torch.Tensor, mult: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def ring_reduce_scatter(x: torch.Tensor, group=None, *,
                        reverse: bool = False) -> torch.Tensor:
    """Unidirectional ring reduce-scatter over ``group``.

    Returns this rank's reduced chunk: rank i holds chunk i (flattened,
    1/n of x zero-padded to a multiple of n).
    """
    n, idx = axis_size(group), axis_index(group)
    flat, _ = _pad_to(x, n)
    chunks = flat.reshape(n, -1)
    if n == 1:
        return chunks[idx]
    sign = -1 if reverse else 1
    # hop s: the partial moves on and picks up this rank's copy of chunk
    # (i - sign * (s + 2)); after n - 1 hops rank i holds all of chunk i
    acc = chunks[(idx - sign) % n]
    for s in range(n - 1):
        acc = _ppermute(acc, group, reverse)
        acc = acc + chunks[(idx - sign * (s + 2)) % n]
    return acc


def ring_all_gather(x: torch.Tensor, group=None, *,
                    reverse: bool = False) -> torch.Tensor:
    """Unidirectional ring all-gather: local chunk -> (n * chunk) flat."""
    n, idx = axis_size(group), axis_index(group)
    sign = -1 if reverse else 1
    out = x.new_zeros((n,) + tuple(x.shape))
    out[idx] = x
    buf = x
    for s in range(n - 1):
        buf = _ppermute(buf, group, reverse)
        out[(idx - sign * (s + 1)) % n] = buf
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def ring_allreduce(x: torch.Tensor, group=None, *,
                   bidirectional: bool = False) -> torch.Tensor:
    """Ring all-reduce (the sum over ``group``), as reduce-scatter then
    all-gather.

    ``bidirectional=True``: the payload split in half over two
    counter-rotating rings — both link directions used (the
    paper-adapted schedule).
    """
    shape, dtype = x.shape, x.dtype
    n = axis_size(group)
    if n == 1:
        return x
    if not bidirectional:
        flat, pad = _pad_to(x, n)
        full = ring_all_gather(ring_reduce_scatter(x, group), group)
        if pad:
            full = full[:flat.shape[0] - pad]
        return full[:x.numel()].reshape(shape).to(dtype)
    flat, pad = _pad_to(x, 2 * n)
    fwd, bwd = flat.reshape(2, -1)
    full_f = ring_all_gather(ring_reduce_scatter(fwd, group), group)
    full_b = ring_all_gather(ring_reduce_scatter(bwd, group, reverse=True),
                             group, reverse=True)
    out = torch.cat([full_f, full_b])
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype)


def wire_bytes_per_direction(n_bytes_payload: int, n_devices: int,
                             bidirectional: bool) -> float:
    """Ring all-reduce ships 2*(n-1)/n of the payload per device.  A
    unidirectional ring puts all of it on one link direction; the
    bidirectional schedule splits it across both — the per-direction (i.e.
    wall-clock-critical) traffic halves, the paper's pin-saving argument in
    byte units."""
    total = 2 * (n_devices - 1) / n_devices * n_bytes_payload
    return total / (2 if bidirectional else 1)
