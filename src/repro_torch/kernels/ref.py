"""Plain-PyTorch versions of the port's kernels: the semantics oracles.

``fabric_queue_scan`` / ``fabric_queue_update`` are the per-micro-
transaction queue step of the slot engine, ported from the reference
``kernels/ref.py``; ``fabric_queue_multistep`` is one launch of the
multi-step kernel, a loop of an injected step over the packed carry;
``lif_step`` is the LIF membrane update; ``aer_encode`` / ``aer_decode``
are the AER payload path's event encoder and decoder;
``selective_scan`` is the Mamba S6 recurrence and
``selective_scan_bwd`` its gradient.
``q_time`` is (Q, C) int32 release times with ``BIG_NS`` (2**30)
marking empty/consumed one-shot slots; ``t_q`` is the (Q,) per-queue
clock.  The CUDA kernels in ``fabric_queue.py``, ``lif_step.py``,
``aer_encode.py`` and ``aer_decode.py`` must match these bit for bit
(NaN where NaN); ``selective_scan.py`` matches its plain version to a
stated tolerance (the order of its N-term sum differs).  They run on any device: the CPU path, and
``engine="reference"`` or a direct call on the card.
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
    b = int(torch.as_tensor(base).reshape(-1)[0])  # torchlint: disable=TL001 (documented: the plain loop)
    carry = tuple(carry)
    consts = tuple(consts)
    for i in range(min(chunk, max_steps - b)):
        carry = tuple(step_fn(carry, consts, b + i))
    return carry


# --- AER payload path: event encoder (TX) and decoder (RX) --------------
#
# The reference computes both as one-hot contractions in float32
# (``src/repro/kernels/ref.py:26-58``): slot e of the encoder receives
# ``x[b_e] + sum over b != b_e of 0 * x[b]``, and ``0 * inf`` and
# ``0 * NaN`` are NaN.  So a non-finite entry anywhere in a row turns
# every slot of the row into NaN except the one that holds it (idx,
# count and wanted are unaffected); the decoder does the same with its
# slots.  The functions below compute that rule explicitly, from a
# per-row count of non-finite entries, by cumsum and scatter: the
# reference's (nb, block, budget) one-hot would take 8.6 GB for one
# full-width MLP weight.

def aer_encode(x: torch.Tensor, tau: torch.Tensor, budget: int):
    """Threshold-encode (nb, block) tiles into ``budget`` event slots.

    Selects ``|x| >= tau & x != 0`` (zeros never ship) in index order
    and keeps the first ``budget``; returns ``(idx, val, count,
    wanted)``: ``idx`` (nb, budget) int32 block-local addresses (-1 for
    a void slot), ``val`` (nb, budget) in x's dtype, ``count =
    min(wanted, budget)`` and ``wanted`` (the row's selected total),
    both (nb,) int32.  ``tau`` is (nb,) or one value, taken in x's
    dtype.  ``val`` of a slot is NaN when the row holds a non-finite
    entry at another position; a void slot is NaN when the row holds
    any, else 0.
    """
    nb, block = x.shape
    tau = torch.as_tensor(tau, device=x.device).to(x.dtype).reshape(-1, 1)  # torchlint: disable=TL002 (the plain version)
    xf = x.float()
    mask = (xf.abs() >= tau.float()) & (xf != 0)
    csum = mask.to(torch.int32).cumsum(1, dtype=torch.int32)
    wanted = csum[:, -1] if block else torch.zeros(
        nb, dtype=torch.int32, device=x.device)
    bad = ~torch.isfinite(xf)
    nf = bad.sum(1, dtype=torch.int32)[:, None]
    nan = torch.tensor(float("nan"), dtype=x.dtype, device=x.device)  # torchlint: disable=TL002 (the plain version)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # a spare last column takes every unselected entry, then is dropped
    dest = torch.where(mask & (csum <= budget), csum - 1, budget).long()
    pos = torch.arange(block, dtype=torch.int32,
                       device=x.device).expand(nb, block)
    idx = torch.full((nb, budget + 1), -1, dtype=torch.int32,  # torchlint: disable=TL002 (the plain version)
                     device=x.device).scatter_(1, dest, pos)
    val = torch.where(nf > 0, nan, zero).expand(nb, budget + 1).clone()
    val.scatter_(1, dest, torch.where(nf - bad.to(torch.int32) > 0, nan, x))
    return (idx[:, :budget].contiguous(), val[:, :budget].contiguous(),
            torch.clamp(wanted, max=budget), wanted)


def aer_decode(idx: torch.Tensor, val: torch.Tensor, block: int):
    """Event slots -> dense (nb, block) in val's dtype.

    ``dense[r, b] = sum of val[r, e] over the slots with idx[r, e] == b``;
    a slot whose idx is < 0 (void) or >= block addresses nothing.  The
    sum runs in float32 from +0 in slot order (so duplicate addresses
    give the same bits every run) and is rounded once to val's dtype.
    ``dense[r, b]`` is NaN when a slot of the row that is not addressed
    to b holds a non-finite value.
    """
    nb, budget = idx.shape
    dev = idx.device
    valid = (idx >= 0) & (idx < block)
    col = torch.where(valid, idx, block).long()      # spare column
    vf = val.float()
    acc = torch.zeros((nb, block + 1), dtype=torch.float32, device=dev)
    rows = torch.arange(nb, device=dev)
    for e in range(budget):       # one slot a row: no colliding targets
        acc[rows, col[:, e]] += vf[:, e]
    # the one address (if any) that holds every non-finite slot keeps
    # its own sum; every other address of such a row is NaN
    bad = ~torch.isfinite(vf)
    nf = bad.sum(1)
    lo = torch.where(bad, col, block + 1).amin(1) if budget else nf
    hi = torch.where(bad, col, -1).amax(1) if budget else nf
    keep = torch.where((nf > 0) & (lo == hi) & (lo < block), lo, -1)
    b = torch.arange(block, device=dev)
    poison = (nf[:, None] > 0) & (b[None, :] != keep[:, None])
    dense = torch.where(poison, float("nan"), acc[:, :block])
    return dense.to(val.dtype)


def _scan_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                   c_ssm: torch.Tensor, a: torch.Tensor):
    """The S6 recurrence as a float32 time-step loop, the counterpart of
    the reference's ``ref.selective_scan_ref``:

        h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·x_t) ⊗ B_t,  h_0 = 0
        y_t = Σ_n h_t·C_t

    x, dt: (B, S, d_in); b_ssm, c_ssm: (B, S, N); a: (d_in, N).  Returns
    ``(y (B, S, d_in), h_final (B, d_in, N))``, float32 (float64 where x
    is float64, as a gradient check wants).
    """
    f = _scan_dtype(x)
    x, dt = x.to(f), dt.to(f)
    b_ssm, c_ssm, a = b_ssm.to(f), c_ssm.to(f), a.to(f)
    bsz, seq, d_in = x.shape
    h = torch.zeros((bsz, d_in, a.shape[1]), dtype=f, device=x.device)
    y = torch.empty_like(x)
    for t in range(seq):
        abar = torch.exp(dt[:, t, :, None] * a)
        bx = (dt[:, t] * x[:, t])[..., None] * b_ssm[:, t, None, :]
        h = abar * h + bx
        y[:, t] = (h * c_ssm[:, t, None, :]).sum(-1)
    return y, h


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor,
                       b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                       a: torch.Tensor, dy: torch.Tensor,
                       dh_final: torch.Tensor | None = None):
    """The gradient of ``selective_scan`` as a reverse-time loop, written
    out term by term: given ``dy`` (B, S, d_in), the cotangent of y, and
    ``dh_final`` (B, d_in, N), that of h_final (None: zeros), returns
    ``(dx, ddt, db, dc, da)`` in float32 (float64 for float64 operands),
    each shaped as its operand.

    With ``a_t = exp(dt_t·A)`` and the carry ``G`` seeded by ``dh_final``,
    for t = S-1 down to 0:

        g_t   = dy_t ⊗ C_t + G                 (dL/dh_t)
        dC_t  = Σ_d dy_t·h_t
        dB_t  = Σ_d g_t·dt_t·x_t
        dx_t  = Σ_n g_t·dt_t·B_t
        ddt_t = Σ_n g_t·(x_t·B_t + A·a_t·h_{t-1})
        dA   += Σ_b g_t·dt_t·a_t·h_{t-1}
        G     = a_t ⊙ g_t

    It stores the forward trajectory h (B, S, d_in, N): it is the plain
    version, which the kernel (``csrc/selective_scan_bwd.cu``) is held
    against, not a path for long sequences.
    """
    f = _scan_dtype(x)
    x, dt, dy = x.to(f), dt.to(f), dy.to(f)
    b_ssm, c_ssm, a = b_ssm.to(f), c_ssm.to(f), a.to(f)
    bsz, seq, d_in = x.shape
    n = a.shape[1]
    dev = x.device
    h = torch.zeros((bsz, d_in, n), dtype=f, device=dev)
    hs = []
    for t in range(seq):
        abar = torch.exp(dt[:, t, :, None] * a)
        bx = (dt[:, t] * x[:, t])[..., None] * b_ssm[:, t, None, :]
        h = abar * h + bx
        hs.append(h)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b_ssm), torch.empty_like(c_ssm)
    da = torch.zeros_like(a)
    zero = torch.zeros((bsz, d_in, n), dtype=f, device=dev)
    g_carry = zero if dh_final is None else dh_final.to(f)
    for t in range(seq - 1, -1, -1):
        dtt = dt[:, t, :, None]                        # (B, d_in, 1)
        xt = x[:, t, :, None]
        bt = b_ssm[:, t, None, :]                      # (B, 1, N)
        abar = torch.exp(dtt * a)
        h_prev = hs[t - 1] if t > 0 else zero
        g = dy[:, t, :, None] * c_ssm[:, t, None, :] + g_carry
        dc[:, t] = (dy[:, t, :, None] * hs[t]).sum(1)
        db[:, t] = (g * (dtt * xt)).sum(1)
        dx[:, t] = (g * dtt * bt).sum(-1)
        ddt[:, t] = (g * (xt * bt + a * abar * h_prev)).sum(-1)
        da += (g * dtt * abar * h_prev).sum(0)
        g_carry = abar * g
    return dx, ddt, db, dc, da
