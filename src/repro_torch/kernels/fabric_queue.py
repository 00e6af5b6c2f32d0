"""CUDA kernels of the slot engine's queue work (Hopper, sm_90a).

Sources: ``csrc/fabric_queue.cu`` (the per-step pair) and
``csrc/fabric_queue_multistep.cu``, each built by ``_build`` into a
library of its own at first use.  The wrappers check their operands,
allocate outputs with ``torch.empty``, launch on PyTorch's current
stream without synchronising, raise on a CUDA error, and count their
launches (``<wrapper>.launches``, a plain int bumped once per kernel
launch and nowhere else).  They take CUDA tensors only; ``ops`` sends
CPU tensors to the plain versions in ``ref``.

``fabric_queue_step`` — replaces ``fabric_queue_step_pallas``
(``src/repro/kernels/fabric_queue.py:109``, body ``scan_math`` at
``:68``).
    Design: one warp per queue row, lanes striding over the C columns;
    each lane keeps its released count, (minimum released time, lowest
    column) and minimum unreleased time, and a shuffle reduction breaks
    ties toward the lower column (the argmin rule).  Lane 0 reads
    ``q_dest[row, amin]`` and writes the six outputs.
    Bound on an H100: bytes.  It must read ``q_time`` once (Q·C·4 B) and
    move 7·Q·4 B besides (``t_q`` in, six outputs out): at the ring-16
    full-width shape (Q = 32, C = 768) about 0.1 MB, ~0.03 µs at
    3.35 TB/s — far below a launch, so the kernel is launch-bound.
    (The head-route gather reads one more word per row.)

``fabric_queue_update`` — replaces ``fabric_queue_update_pallas``
(``src/repro/kernels/fabric_queue.py:195``, body ``update_math`` at
``:142``).
    Design: one thread per lane over the Lp pop lanes and La append
    lanes, writing the three planes **in place** (the wrapper returns the
    same tensors).  Lanes whose queue id is not in [0, Q) skip.  No
    atomics: append targets are unique and disjoint from pop slots.  The
    TPU kernel's one-hot-matmul scatter, which rewrites all Q·C words of
    each plane, is not carried over.  In place is safe because the
    engine reads ``q_inj[qid, pop_slot]`` before it calls the update.
    Bound on an H100: bytes, about (Lp + 3·La)·4 B written plus the lane
    operands read once — a few hundred bytes; launch-bound.

``fabric_queue_multistep`` — replaces ``fabric_queue_multistep_pallas``
(``src/repro/kernels/fabric_queue.py:238``).
    One launch runs ``min(chunk, max_steps - base)`` whole slot-engine
    micro-transactions on the packed carry (``core.network.
    _pack_slot_state``), **in place**.  The TPU kernel traces the step
    in as a closure; this kernel carries ``_slot_step_body`` itself:
    queue scan, flow gate, horizon, the two-pass link FSM, pops,
    delivery log, replication, forward slots, appends and telemetry.
    Design: one thread block per instance (a leading batch axis B; the
    engine passes B = 1); a warp per queue row for the scan, a thread
    per link or lane for the rest, a barrier between phases.  The slot
    planes and the log stay in global memory (L2): at ring-16 full width
    the carry is 306,312 B, over the 227 KB a block may have.  The lane
    and side planes, counters and per-step temporaries live in shared
    memory for the whole launch and are written back once.
    Bound on an H100: the scan's int32 operations, 4·Q·C a step (12.6 M
    a 128-step launch at full width, ~0.75 µs at the int32 rate of
    ~16.7 T/s), over the bytes if each input is read once and each
    output written once — about 2 × ``slot_carry_bytes`` (0.61 MB at
    full width, ~0.18 µs at 3.35 TB/s) a launch; but each step re-scans the
    Q·C slot plane (98 KB at full width, from L2), and the phases are a
    chain of dependent block-wide steps, so latency (barriers, L2
    round trips), not bandwidth, sets its time.  Nothing in the design
    hides that yet: it is the simple, bit-exact first version.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.network import _MS_LANES, _MS_SIDES
from . import _build

__all__ = ["fabric_queue_step", "fabric_queue_update",
           "fabric_queue_multistep"]

_I32 = torch.int32


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    _build.check_operands(name, dev, _I32, **tensors)


def fabric_queue_step(q_time: torch.Tensor, q_dest: torch.Tensor,
                      t_q: torch.Tensor):
    """Fused queue-step reductions on the card.

    ``q_time`` / ``q_dest``: (Q, C) int32 (``BIG_NS`` = empty slot);
    ``t_q``: (Q,) int32 per-queue clock.  Returns ``(pend, r_min, nxt,
    amin, busy, head_route)``, each (Q,) int32 (rows of one (6, Q)
    allocation).
    """
    dev = q_time.device
    if dev.type != "cuda":
        raise ValueError(f"fabric_queue_step launches a CUDA kernel; got "
                         f"a tensor on {dev} (ops.fabric_queue_scan runs "
                         f"the plain version on the CPU)")
    _check_cuda("fabric_queue_step", dev, q_time=q_time, q_dest=q_dest,
                t_q=t_q)
    if q_time.dim() != 2 or q_dest.shape != q_time.shape:
        raise ValueError(f"fabric_queue_step: q_time {tuple(q_time.shape)}"
                         f" and q_dest {tuple(q_dest.shape)} must be one "
                         f"(Q, C) shape")
    nq, nc = q_time.shape
    if t_q.shape != (nq,) or nc < 1:
        raise ValueError(f"fabric_queue_step: t_q must be ({nq},) and "
                         f"C >= 1, got {tuple(t_q.shape)}, C={nc}")
    out = torch.empty((6, nq), dtype=_I32, device=dev)
    if nq == 0:
        return tuple(out.unbind(0))
    lib = _build.load("fabric_queue")
    row = out.data_ptr()
    rc = lib.fabric_queue_step_launch(
        q_time.data_ptr(), q_dest.data_ptr(), t_q.data_ptr(), nq, nc,
        *(row + 4 * nq * i for i in range(6)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fabric_queue_step")
    fabric_queue_step.launches += 1
    return tuple(out.unbind(0))


fabric_queue_step.launches = 0


def fabric_queue_update(q_time, q_dest, q_inj, pop_q, pop_slot,
                        app_q, app_slot, app_t, app_dest, app_inj):
    """Pop-consume + forward-append scatter on the card, **in place**.

    Three (Q, C) int32 planes; (Lp,) pop lanes; (La,) append lanes.
    Returns the (updated) planes themselves.
    """
    dev = q_time.device
    if dev.type != "cuda":
        raise ValueError(f"fabric_queue_update launches a CUDA kernel; "
                         f"got a tensor on {dev} (ops.fabric_queue_update "
                         f"runs the plain version on the CPU)")
    _check_cuda("fabric_queue_update", dev, q_time=q_time, q_dest=q_dest,
                q_inj=q_inj, pop_q=pop_q, pop_slot=pop_slot, app_q=app_q,
                app_slot=app_slot, app_t=app_t, app_dest=app_dest,
                app_inj=app_inj)
    if q_time.dim() != 2 or q_dest.shape != q_time.shape \
            or q_inj.shape != q_time.shape:
        raise ValueError("fabric_queue_update: the three planes must share "
                         "one (Q, C) shape")
    n_pop, n_app = pop_q.numel(), app_q.numel()
    if pop_q.shape != (n_pop,) or pop_slot.shape != (n_pop,):
        raise ValueError("fabric_queue_update: pop_q / pop_slot must be "
                         "one (Lp,) shape")
    for t in (app_slot, app_t, app_dest, app_inj):
        if t.shape != (n_app,):
            raise ValueError("fabric_queue_update: the append lanes must "
                             "share app_q's (La,) shape")
    nq, nc = q_time.shape
    if n_pop + n_app == 0:
        return q_time, q_dest, q_inj
    lib = _build.load("fabric_queue")
    rc = lib.fabric_queue_update_launch(
        q_time.data_ptr(), q_dest.data_ptr(), q_inj.data_ptr(), nq, nc,
        pop_q.data_ptr(), pop_slot.data_ptr(), n_pop,
        app_q.data_ptr(), app_slot.data_ptr(), app_t.data_ptr(),
        app_dest.data_ptr(), app_inj.data_ptr(), n_app,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fabric_queue_update")
    fabric_queue_update.launches += 1
    return q_time, q_dest, q_inj


fabric_queue_update.launches = 0


def fabric_queue_multistep(carry, consts, base, *, chunk: int,
                           max_steps: int, max_burst: int):
    """``min(chunk, max_steps - base)`` micro-transactions on the card,
    in one launch, **in place** on the carry, which it returns.

    ``carry``: ``(q_time, q_dest, q_inj (Q, C), lanes (16, L), sides
    (9, L, 2), logs (3, E + 1), counters (2,))``; ``consts``: ``(links
    (L, 2), route_out (N, R, K), route_del (N, R), route_wt (N, R, K),
    timing (3, L), params (3,))``; ``base``: (1,), read on the card.
    Every carry and const tensor may carry one leading instance axis B
    (all or none of them): the launch then runs B instances, one block
    each, all from the same ``base``.
    """
    dev = carry[0].device
    if dev.type != "cuda":
        raise ValueError(f"fabric_queue_multistep launches a CUDA kernel; "
                         f"got a tensor on {dev} (ops.fabric_queue_"
                         f"multistep runs the plain version on the CPU)")
    carry, consts = tuple(carry), tuple(consts)
    if len(carry) != 7 or len(consts) != 6:
        raise ValueError("fabric_queue_multistep: carry is 7 tensors and "
                         "consts 6")
    names = ("q_time", "q_dest", "q_inj", "lanes", "sides", "logs",
             "counters", "links", "route_out", "route_del", "route_wt",
             "timing", "params")
    ops = dict(zip(names, carry + consts))
    _check_cuda("fabric_queue_multistep", dev, base=base, **ops)
    batched = carry[0].dim() == 3
    n_inst = carry[0].shape[0] if batched else 1
    lead = (n_inst,) if batched else ()
    nq, nc = carry[0].shape[-2:]
    n_links, n_log = nq // 2, carry[5].shape[-1] - 1
    if consts[1].dim() != len(lead) + 3:
        raise ValueError(f"fabric_queue_multistep: route_out must be "
                         f"{len(lead) + 3}-d, got "
                         f"{tuple(consts[1].shape)}")
    n_chips, n_routes, k = consts[1].shape[-3:]
    want = {"q_time": (nq, nc), "q_dest": (nq, nc), "q_inj": (nq, nc),
            "lanes": (len(_MS_LANES), n_links),
            "sides": (len(_MS_SIDES), n_links, 2),
            "logs": (3, n_log + 1), "counters": (2,), "links": (n_links, 2),
            "route_out": (n_chips, n_routes, k),
            "route_del": (n_chips, n_routes),
            "route_wt": (n_chips, n_routes, k), "timing": (3, n_links),
            "params": (3,)}
    for arg, shape in want.items():
        if tuple(ops[arg].shape) != lead + shape:
            raise ValueError(f"fabric_queue_multistep: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected "
                             f"{lead + shape}")
    if nq % 2 or n_links < 1 or nc < 1 or n_log < 0 or n_chips < 1 \
            or n_routes < 1 or k < 1:
        raise ValueError(f"fabric_queue_multistep: empty or odd operands "
                         f"(Q={nq}, C={nc}, E={n_log}, N={n_chips}, "
                         f"R={n_routes}, K={k})")
    if base.shape != (1,):
        raise ValueError(f"fabric_queue_multistep: base must be (1,), got "
                         f"{tuple(base.shape)}")
    if chunk < 1 or max_steps < 0 or max_burst < 0:
        raise ValueError(f"fabric_queue_multistep: chunk >= 1, max_steps "
                         f">= 0 and max_burst >= 0, got {chunk}, "
                         f"{max_steps}, {max_burst}")
    lib = _build.load("fabric_queue_multistep")
    smem = lib.fabric_queue_multistep_smem_bytes(n_links, k)
    limit = ctypes.c_int()
    _build.check(lib, lib.fabric_queue_multistep_smem_limit(limit),
                 "fabric_queue_multistep")
    if smem > limit.value:
        raise ValueError(
            f"fabric_queue_multistep: L={n_links} links with K={k} need "
            f"{smem} bytes of shared memory per block, over the "
            f"{limit.value} a block may have on this card; use "
            f"kernel='step' for this fabric")
    rc = lib.fabric_queue_multistep_launch(
        *(t.data_ptr() for t in carry + consts), base.data_ptr(), n_inst,
        n_links, nc, n_log, n_chips, n_routes, k, chunk, max_steps,
        max_burst, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fabric_queue_multistep")
    fabric_queue_multistep.launches += 1
    return carry


fabric_queue_multistep.launches = 0
