"""Plain-PyTorch versions of the port's kernels: the semantics oracles.

``fabric_queue_scan`` / ``fabric_queue_update`` are the per-micro-
transaction queue step of the slot engine, ported from the reference
``kernels/ref.py``; ``fabric_queue_multistep`` is one launch of the
multi-step kernel, a loop of an injected step over the packed carry;
``lif_step`` is the LIF membrane update.
``q_time`` is (Q, C) int32 release times with ``BIG_NS`` (2**30)
marking empty/consumed one-shot slots; ``t_q`` is the (Q,) per-queue
clock.  The CUDA kernels in ``fabric_queue.py`` and ``lif_step.py`` must
match these bit for bit.  They run on any device: the CPU path of the
engine, and ``engine="reference"`` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.protocol_sim import BIG_NS

_I32 = torch.int32


def lif_step(v: torch.Tensor, i_syn: torch.Tensor, decay: float,
             v_th: float, v_reset: float):
    """Fused LIF update on float32 state: ``v2 = v * decay + i_syn``,
    ``spike = v2 >= v_th``, ``v_next = v_reset where spike else v2``.
    Returns ``(v_next, spikes)``, spikes 0.0 / 1.0 in float32.

    ``v2`` is rounded ONCE, as a fused multiply-add: the reference's
    running paths call its LIF update under ``jax.jit``, and XLA
    contracts ``v * decay + i`` into one FMA (the reference's
    ``ref.lif_step`` called eagerly rounds twice and is not what runs).
    The product of two float32 values is exact in float64, so
    ``(v.double() * decay + i.double()).float()`` is that FMA, except
    where the float64 sum itself rounds and the second rounding to
    float32 lands on the other neighbour (a double rounding, about one
    input in 2**29).  ``decay``, ``v_th`` and ``v_reset`` are rounded to
    float32 first, as the reference's ``jnp.asarray(x, v.dtype)`` does.
    """
    if v.dtype != torch.float32 or i_syn.dtype != torch.float32:
        raise TypeError(f"lif_step takes float32 state, got {v.dtype} and "
                        f"{i_syn.dtype}")
    d, th, rst = (float(np.float32(x)) for x in (decay, v_th, v_reset))
    v2 = (v.double() * d + i_syn.double()).float()
    spike = v2 >= th
    v_next = torch.where(spike, torch.full_like(v2, rst), v2)
    return v_next, spike.to(torch.float32)


def fabric_queue_scan(q_time: torch.Tensor, q_dest: torch.Tensor,
                      t_q: torch.Tensor):
    """Per-queue released count / min release / next arrival / argmin
    pop / backlog indicator / head route.

    Returns ``(pend, r_min, nxt, amin, busy, head_route)``, each (Q,)
    int32.  ``amin`` is the first slot of the minimum of
    ``where(released, q_time, BIG_NS)`` (FIFO among equal release
    times; 0 on a row with nothing released) and ``head_route`` is
    ``q_dest[q, amin[q]]`` — garbage but valid on such a row.
    """
    released = q_time <= t_q[:, None]
    pend = released.sum(dim=1, dtype=_I32)
    val = torch.where(released, q_time, BIG_NS)
    r_min = val.amin(dim=1)
    nxt = torch.where(released, BIG_NS, q_time).amin(dim=1)
    amin = torch.argmin(val, dim=1)          # first minimum, like jnp
    busy = (pend > 0).to(_I32)
    head_route = q_dest.gather(1, amin[:, None])[:, 0]
    return pend, r_min, nxt, amin.to(_I32), busy, head_route


def _put(plane: torch.Tensor, q: torch.Tensor, slot: torch.Tensor, val):
    """``plane[q, slot] = val`` on the lanes with ``0 <= q < Q`` and
    ``0 <= slot < C``; other lanes write nothing (JAX's ``mode="drop"``).

    Written as an accumulating put of ``val - current`` so that masked
    lanes add 0 and no data-dependent shape (a host sync on the card)
    arises.  Targets of the unmasked lanes are unique, so the sum is the
    assignment; int32 wrap-around cancels exactly.
    """
    nq, nc = plane.shape
    ok = (q >= 0) & (q < nq) & (slot >= 0) & (slot < nc)
    flat = torch.where(ok, q * nc + slot, 0).long()
    cur = plane.view(-1)[flat]
    plane.view(-1).index_put_((flat,), torch.where(ok, val - cur, 0),
                              accumulate=True)


def fabric_queue_update(q_time, q_dest, q_inj, pop_q, pop_slot,
                        app_q, app_slot, app_t, app_dest, app_inj):
    """Consume popped slots (back to ``BIG_NS``) and append forwarded
    copies, **in place** on the three (Q, C) planes, which it returns.

    ``pop_q`` / ``pop_slot``: (Lp,) lanes; ``app_*``: (La,) lanes (La =
    Lp·K under in-fabric multicast).  A lane whose queue id is >= Q
    writes nothing.  Append targets are unique (queue, slot) pairs and
    pop and append slots are disjoint (appends land at ``n_ins``, beyond
    every released slot).
    """
    _put(q_time, pop_q, pop_slot, BIG_NS)
    _put(q_time, app_q, app_slot, app_t)
    _put(q_dest, app_q, app_slot, app_dest)
    _put(q_inj, app_q, app_slot, app_inj)
    return q_time, q_dest, q_inj


def fabric_queue_multistep(carry, consts, base, *, step_fn, chunk: int,
                           max_steps: int):
    """One launch of the multi-step kernel, plainly: step the packed
    carry ``min(chunk, max_steps - base)`` times (none when that is not
    positive) with ``carry = step_fn(carry, consts, base + i)``.

    ``base`` is a (1,) int32 tensor, the global index of the launch's
    first step; it is read back to the host, which on the card costs a
    synchronisation per call (the kernel reads it on the device).  The
    engine injects ``step_fn`` (``core.network._multistep_step_fn``,
    one ``_slot_step_body`` micro-transaction), as the reference does,
    so this module needs nothing of the engine.  Returns the stepped
    carry tuple.
    """
    b = int(torch.as_tensor(base).reshape(-1)[0])
    carry = tuple(carry)
    consts = tuple(consts)
    for i in range(min(chunk, max_steps - b)):
        carry = tuple(step_fn(carry, consts, b + i))
    return carry
