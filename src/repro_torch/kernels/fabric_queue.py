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
    Design: one block per queue row (2 warps up to C = 1024 columns, 4
    above), so every row has an SM of its own at the main-path shapes;
    every load of a row is made before any reduction (the row's
    16-byte-aligned middle as unrolled ``int4`` loads, the 0-3 columns
    either side as scalar loads), ``q_dest`` is read in the same pass and
    each thread carries (value, column, dest) of its minimum, so
    ``head_route`` needs no dependent gather; warp shuffles and one
    shared-memory exchange then reduce, lowest column winning a tie (the
    argmin rule).  One memory round trip a row, from L2: the planes are
    updated in place every step.
    Bound on an H100: bytes.  It must read ``q_time`` once (Q·C·4 B) and
    move 7·Q·4 B besides (``t_q`` in, six outputs out): at the ring-16
    full-width shape (Q = 32, C = 768) about 0.1 MB, ~0.03 µs at
    3.35 TB/s — far below a launch, so the kernel is launch-bound.
    (Reading ``q_dest`` in the same pass doubles what it reads from L2.)

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
    Bound on an H100: latency.  The int32 operations of a full-width
    scan (4·Q·C a step, ~0.75 µs a 128-step launch at ring-16 full
    width) and the carry's bytes (~0.2 µs) are far below what a chain of
    dependent phases, 128 steps long, takes on one SM.
    Design (``csrc/fabric_queue_multistep.cu`` says more): one block per
    instance (a leading batch axis B; the engine passes B = 1), a thread
    a link holding its link's state in registers for the launch (at most
    ``MS_MAX_LINKS`` links; at every main-path cell all in the first
    warp, whose link phases need only ``__syncwarp``), and the whole
    block (at least eight warps) on the queue scan, several lanes a row.
    Each queue row keeps a live window ``[lo, hi)`` outside which every
    column holds ``BIG_NS`` and, from tier 1, a bitmap of its slots that
    are not ``BIG_NS``; the scan visits only those (the full row where
    the clock is at or past ``BIG_NS``), and skips a row whose results
    cannot have changed.  The delivery prefix is a ballot, the append
    offsets a ``__match_any_sync``.  What fits the 227 KB of shared memory a block
    may opt in to stays there for the launch, by tier
    (``multistep_tier``): the routing tables and the bitmap, then
    ``q_time``, ``q_dest`` and ``q_inj``, copied in and out once with
    Hopper's bulk copy.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.network import _MS_LANES, _MS_SIDES
from . import _build

__all__ = ["fabric_queue_step", "fabric_queue_update",
           "fabric_queue_multistep", "multistep_layout_bytes",
           "multistep_tier", "H100_SMEM_OPTIN", "MS_TIERS",
           "MS_MAX_LINKS"]

_I32 = torch.int32

#: dynamic shared memory a block may opt in to on an H100, in bytes
H100_SMEM_OPTIN = 232_448
#: the multi-step kernel's shared scalars (mbarrier included) and its
#: per-queue, per-link and per-lane arrays
_MS_SCALARS, _MS_PER_QUEUE, _MS_PER_LINK, _MS_PER_LANE = 8, 16, 5, 4
#: residency tiers: nothing, + tables and slot bitmap, + q_time,
#: + q_dest, + q_inj
MS_TIERS = ("base", "tables", "q_time", "q_dest", "q_inj")
#: the most links a launch takes (a thread a link)
MS_MAX_LINKS = 1024


def _ms_base_words(n_links: int, k: int) -> int:
    words = (_MS_SCALARS + _MS_PER_QUEUE * 2 * n_links
             + _MS_PER_LINK * n_links + _MS_PER_LANE * n_links * k)
    return -(-words // 4) * 4


def _ms_plane_pitch(n_cols: int) -> int:
    pitch = -(-n_cols // 4) * 4
    return pitch + 4 if pitch % 8 == 0 else pitch


def multistep_layout_bytes(n_links: int, k: int, n_cols: int, n_chips: int,
                           n_routes: int, tier: int) -> int:
    """Dynamic shared memory of a multi-step launch at ``tier`` (0 to 4),
    in bytes: the base section (``fabric_queue_multistep_smem_bytes``),
    then ``tier - 1`` resident (Q, C) planes at a row pitch of C rounded
    up to 4 words and to 4 mod 8, then (tier >= 1) a bitmap of the slots
    that are not ``BIG_NS`` (ceil(C / 32) words a row) and ``route_out``,
    ``route_wt`` and ``route_del``.  The kernel's ``layout_bytes``
    computes the same; chip_smoke holds the two equal."""
    words = _ms_base_words(n_links, k)
    if tier >= 1:
        words += 2 * n_links * -(-n_cols // 32)
        words += n_chips * n_routes * (2 * k + 1)
    if tier >= 2:
        words += (tier - 1) * 2 * n_links * _ms_plane_pitch(n_cols)
    return 4 * words


def multistep_tier(n_links: int, k: int, n_cols: int, n_chips: int,
                   n_routes: int, limit: int = H100_SMEM_OPTIN) -> int:
    """The highest residency tier whose layout fits ``limit`` bytes
    (``MS_TIERS`` names them), or -1 where even the base section does
    not fit (the kernel cannot run the fabric)."""
    for tier in range(len(MS_TIERS) - 1, -1, -1):
        if multistep_layout_bytes(n_links, k, n_cols, n_chips, n_routes,
                                  tier) <= limit:
            return tier
    return -1


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
    if nq * nc >= 2**31 or n_chips * n_routes * k >= 2**31:
        raise ValueError(f"fabric_queue_multistep: a (Q, C) = ({nq}, {nc}) "
                         f"plane or an (N, R, K) table of 2**31 words or "
                         f"more; the kernel indexes them with int32")
    if chunk < 1 or max_steps < 0 or max_burst < 0:
        raise ValueError(f"fabric_queue_multistep: chunk >= 1, max_steps "
                         f">= 0 and max_burst >= 0, got {chunk}, "
                         f"{max_steps}, {max_burst}")
    lib = _build.load("fabric_queue_multistep")
    limit = ctypes.c_int()
    _build.check(lib, lib.fabric_queue_multistep_smem_limit(limit),
                 "fabric_queue_multistep")
    tier = multistep_tier(n_links, k, nc, n_chips, n_routes, limit.value)
    if tier < 0 or n_links > MS_MAX_LINKS:
        smem = lib.fabric_queue_multistep_smem_bytes(n_links, k)
        raise ValueError(
            f"fabric_queue_multistep: L={n_links} links with K={k} need "
            f"{n_links} threads and {smem} bytes of shared memory per "
            f"block, over the {MS_MAX_LINKS} threads or the {limit.value} "
            f"bytes a block may have on this card; use kernel='step' for "
            f"this fabric")
    rc = lib.fabric_queue_multistep_launch(
        *(t.data_ptr() for t in carry + consts), base.data_ptr(), n_inst,
        n_links, nc, n_log, n_chips, n_routes, k, chunk, max_steps,
        max_burst, tier, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fabric_queue_multistep")
    fabric_queue_multistep.launches += 1
    return carry


fabric_queue_multistep.launches = 0
