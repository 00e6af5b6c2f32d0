"""CUDA kernels of the slot engine's per-step queue work (Hopper, sm_90a).

Source: ``csrc/fabric_queue.cu``, built by ``_build`` at first use.  The
wrappers check their operands, allocate outputs with ``torch.empty``,
launch on PyTorch's current stream without synchronising, raise on a
CUDA error, and count their launches (``<wrapper>.launches``, a plain
int bumped once per kernel launch and nowhere else).  They take CUDA
tensors only; ``ops`` sends CPU tensors to the plain versions in
``ref``.

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
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["fabric_queue_step", "fabric_queue_update"]

_I32 = torch.int32


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    # the C entry launches on the current device: refuse another one
    # rather than switching devices on every launch
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {dev} but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != _I32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


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
