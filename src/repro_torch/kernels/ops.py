"""Device dispatch of the port's kernels.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain version in ``ref``.  There is no
environment override and no fallback: on the card the plain path is
reached only through ``engine="reference"``, which calls ``ref``
directly.
"""

from __future__ import annotations

import torch

from . import fabric_queue as fq
from . import ref

__all__ = ["fabric_queue_scan", "fabric_queue_update",
           "fabric_queue_multistep"]


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def fabric_queue_scan(q_time, q_dest, t_q):
    """Per-queue ``(pend, r_min, nxt, amin, busy, head_route)``."""
    if _on_cuda(q_time, "fabric_queue_scan"):
        return fq.fabric_queue_step(q_time, q_dest, t_q)
    return ref.fabric_queue_scan(q_time, q_dest, t_q)


def fabric_queue_update(q_time, q_dest, q_inj, pop_q, pop_slot,
                        app_q, app_slot, app_t, app_dest, app_inj):
    """Pop-consume + forward-append, in place on the three planes."""
    args = (q_time, q_dest, q_inj, pop_q, pop_slot, app_q, app_slot, app_t,
            app_dest, app_inj)
    if _on_cuda(q_time, "fabric_queue_update"):
        return fq.fabric_queue_update(*args)
    return ref.fabric_queue_update(*args)


def fabric_queue_multistep(carry, consts, base, *, step_fn, chunk: int,
                           max_steps: int, max_burst: int):
    """``min(chunk, max_steps - base)`` micro-transactions on the packed
    carry.  On CUDA one launch of the Hopper kernel, which carries the
    step itself (``step_fn`` is not used) and updates the carry in
    place; on the CPU the plain loop of ``step_fn``."""
    if _on_cuda(carry[0], "fabric_queue_multistep"):
        return fq.fabric_queue_multistep(carry, consts, base, chunk=chunk,
                                         max_steps=max_steps,
                                         max_burst=max_burst)
    return ref.fabric_queue_multistep(carry, consts, base, step_fn=step_fn,
                                      chunk=chunk, max_steps=max_steps)
