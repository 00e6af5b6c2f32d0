"""Discrete-event simulator of two linked AE transceiver blocks (Figs. 1–2).

The PyTorch counterpart of the reference ``core/protocol_sim.py``: one
step is one *micro-transaction* — a simultaneous FSM evaluation of both
blocks, then at most one bus action (TRANSMIT, HANDSHAKE or IDLE; see
the reference's module docstring).  All arithmetic is int32 and exact
in nanoseconds.

``link_step`` is elementwise, so the fabric's batch of L links is the
same function on (L,) tensors (``link_step_batch``); ``simulate`` drives
one link with sorted-arrival pending counts, and the 2-chip fabric
reproduces it bit-exactly because both run this one function.
``lax.scan`` becomes a Python loop over steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .link import LinkTiming, PAPER_TIMING
from .transceiver import RX, TX, XcvrState, reset_state
from .transceiver import settle as fsm_settle

# Trace action codes
A_IDLE, A_HANDSHAKE, A_TX_L, A_TX_R = 0, 1, 2, 3

#: "no further arrival" sentinel of the int32 clocks (a plain int)
BIG_NS = 2**30

_I32 = torch.int32


class LinkState(NamedTuple):
    """Carry of one bi-directional link (or, with (L,) leaves, of L)."""
    t: torch.Tensor          # int32 ns — link-local clock
    xl: XcvrState
    xr: XcvrState
    last_dir: torch.Tensor   # direction of previous transmission (1 = L->R)
    bus_busy: torch.Tensor   # 1 if a transmission stream is alive
    prev_tx_l: torch.Tensor  # did L transmit last step (rx_strobe for R)
    prev_tx_r: torch.Tensor


class LinkStepOut(NamedTuple):
    action: torch.Tensor   # A_IDLE / A_HANDSHAKE / A_TX_L / A_TX_R
    tx_l: torch.Tensor     # int32: 1 iff L shipped an event this step
    tx_r: torch.Tensor     # int32: 1 iff R shipped an event this step


def reset_link(initial_tx=1, device=None) -> LinkState:
    """Global reset of one link pair; ``initial_tx`` may be an int or an
    int tensor of shape (L,) (one polarity per link)."""
    m = torch.as_tensor(initial_tx, dtype=_I32, device=device)
    z = torch.zeros_like(m)
    return LinkState(t=z, xl=reset_state(m), xr=reset_state(1 - m),
                     last_dir=m.clone(), bus_busy=z.clone(),
                     prev_tx_l=z.clone(), prev_tx_r=z.clone())


def _cost(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=like.device)


def transact(s: LinkState, pend_l, pend_r, t_next_arr, t_cycle, t_rev,
             t_idle_sw, max_burst=0):
    """One micro-transaction, what :func:`link_step` computes before its
    trace code: ``(new_state, tx_l, tx_r, settling)``, the last three
    bool tensors.  The costs are int32 tensors (or 0-d) broadcasting
    against ``s.t``; the fabric engines call this directly."""
    # FSM evaluation with wire settling: two iterations reach the fixed
    # point (one edge triggers at most one response edge); receive
    # strobes are edges and feed only the first iteration
    xl = fsm_settle(s.xl, s.xr.sw_ack, pend_l, s.prev_tx_r, max_burst)
    xr = fsm_settle(s.xr, s.xl.sw_ack, pend_r, s.prev_tx_l, max_burst)
    xl, xr = (fsm_settle(xl, xr.sw_ack, pend_l, 0, max_burst),
              fsm_settle(xr, xl.sw_ack, pend_r, 0, max_burst))

    l_tx = xl.mode == TX
    r_tx = xr.mode == TX
    tx_l = l_tx & ~r_tx & (pend_l > 0)      # xr.mode == RX
    tx_r = r_tx & ~l_tx & (pend_r > 0)
    do_tx = tx_l | tx_r
    tx_l32 = tx_l.to(_I32)                   # also the direction now
    tx_r32 = tx_r.to(_I32)

    reversal = tx_l32 != s.last_dir
    # a reversal pays the penalty on a live stream, the idle switch else
    cost = torch.where(reversal, t_cycle + torch.where(
        s.bus_busy == 1, t_rev, t_idle_sw), t_cycle)

    settling = (xl.sw_ack != s.xl.sw_ack) | (xr.sw_ack != s.xr.sw_ack) \
        | (xl.mode != s.xl.mode) | (xr.mode != s.xr.mode)

    # idle: nothing pending, nothing to settle -> jump to the next
    # arrival; with none scheduled the clock parks
    active = do_tx | settling
    new_t = torch.where(do_tx, s.t + cost,
                        torch.where(~active & (t_next_arr < BIG_NS),
                                    t_next_arr, s.t))
    ns = LinkState(
        t=new_t, xl=xl._replace(burst=xl.burst + tx_l32),
        xr=xr._replace(burst=xr.burst + tx_r32),
        last_dir=torch.where(do_tx, tx_l32, s.last_dir),
        # a transmission keeps the bus busy, an idle step frees it
        bus_busy=(s.bus_busy & active) | do_tx,
        prev_tx_l=tx_l32, prev_tx_r=tx_r32)
    return ns, tx_l, tx_r, settling


def link_step(s: LinkState, pend_l, pend_r, t_next_arr, *,
              timing: LinkTiming = PAPER_TIMING, max_burst: int = 0,
              t_cycle_ns=None, t_rev_ns=None, t_idle_sw_ns=None):
    """One micro-transaction: FSM settling + at most one bus act.

    ``pend_l`` / ``pend_r`` / ``t_next_arr`` are int32 tensors shaped
    like ``s.t``; the optional cost overrides are int32 tensors of the
    same shape (per-link timing) and replace ``timing``'s scalars.
    Returns ``(new_state, LinkStepOut)``.
    """
    t_cycle = _cost(timing.t_req2req_ns if t_cycle_ns is None
                    else t_cycle_ns, s.t)
    t_rev = _cost(timing.t_reverse_penalty_ns if t_rev_ns is None
                  else t_rev_ns, s.t)
    t_idle_sw = _cost(timing.t_idle_switch_ns if t_idle_sw_ns is None
                      else t_idle_sw_ns, s.t)
    ns, tx_l, tx_r, settling = transact(s, pend_l, pend_r, t_next_arr,
                                        t_cycle, t_rev, t_idle_sw,
                                        max_burst)
    action = torch.where(tx_l, A_TX_L, torch.where(
        tx_r, A_TX_R, torch.where(settling, A_HANDSHAKE, A_IDLE)))
    return ns, LinkStepOut(action=action.to(_I32), tx_l=ns.prev_tx_l,
                           tx_r=ns.prev_tx_r)


def link_step_batch(state: LinkState, pend_l, pend_r, t_next_arr, *,
                    timing: LinkTiming = PAPER_TIMING, max_burst: int = 0,
                    timing_arrays=None):
    """One micro-transaction on a batch of links: ``link_step`` on (L,)
    tensors (elementwise ops in place of ``vmap``).  ``timing_arrays``
    is an optional ``(t_cycle, t_rev, t_idle_sw)`` triple of (L,) int32
    tensors giving each link its own costs."""
    if timing_arrays is None:
        return link_step(state, pend_l, pend_r, t_next_arr, timing=timing,
                         max_burst=max_burst)
    t_cycle, t_rev, t_idle_sw = timing_arrays
    return link_step(state, pend_l, pend_r, t_next_arr, timing=timing,
                     max_burst=max_burst, t_cycle_ns=t_cycle,
                     t_rev_ns=t_rev, t_idle_sw_ns=t_idle_sw)


class SimTrace(NamedTuple):
    t: torch.Tensor        # (steps,) time after the step
    action: torch.Tensor   # (steps,) action code
    mode_l: torch.Tensor
    mode_r: torch.Tensor
    sw_ack_l: torch.Tensor
    sw_ack_r: torch.Tensor


class SimResult(NamedTuple):
    trace: SimTrace
    sent_l: torch.Tensor
    sent_r: torch.Tensor
    t_end: torch.Tensor
    n_switches: torch.Tensor


def _pending(arrivals: torch.Tensor, t: torch.Tensor, sent: torch.Tensor):
    arrived = torch.searchsorted(arrivals, t.reshape(1), right=True)[0]
    return arrived.to(_I32) - sent


def _next_arrival(arrivals: torch.Tensor, t: torch.Tensor):
    n = arrivals.shape[0]
    if n == 0:
        return torch.full_like(t, BIG_NS)
    i = torch.searchsorted(arrivals, t.reshape(1), right=True)[0]
    return torch.where(i < n, arrivals[torch.clamp(i, max=n - 1)], BIG_NS)


def simulate(arr_l, arr_r, *, timing: LinkTiming = PAPER_TIMING,
             initial_tx: int = 1, max_burst: int = 0,
             max_steps: int | None = None, device=None) -> SimResult:
    """Run the two-block simulation for ``max_steps`` micro-transactions.

    ``arr_l`` / ``arr_r`` are sorted int32 ns arrival times on each side
    (tensors or arrays); ``max_steps`` defaults to 3·(n_l + n_r) + 16.
    ``device=None`` means CUDA (raises without it).
    """
    dev = resolve_device(device)
    arr_l = torch.as_tensor(arr_l, dtype=_I32).to(dev)
    arr_r = torch.as_tensor(arr_r, dtype=_I32).to(dev)
    n_l, n_r = arr_l.shape[0], arr_r.shape[0]
    if max_steps is None:
        max_steps = 3 * (n_l + n_r) + 16

    link = reset_link(initial_tx, device=dev)
    sent_l = torch.zeros((), dtype=_I32, device=dev)
    sent_r = torch.zeros((), dtype=_I32, device=dev)
    recs = []
    for _ in range(max_steps):
        t = link.t
        pend_l = _pending(arr_l, t, sent_l)
        pend_r = _pending(arr_r, t, sent_r)
        t_next = torch.minimum(_next_arrival(arr_l, t),
                               _next_arrival(arr_r, t))
        link, out = link_step(link, pend_l, pend_r, t_next, timing=timing,
                              max_burst=max_burst)
        sent_l = sent_l + out.tx_l
        sent_r = sent_r + out.tx_r
        recs.append(torch.stack([link.t, out.action, link.xl.mode,
                                 link.xr.mode, link.xl.sw_ack,
                                 link.xr.sw_ack]))
    cols = (torch.stack(recs, 1) if recs
            else torch.zeros((6, 0), dtype=_I32, device=dev))
    trace = SimTrace(*cols.unbind(0))
    n_switches = (trace.mode_l[1:] != trace.mode_l[:-1]).sum(dtype=_I32)
    return SimResult(trace=trace, sent_l=sent_l, sent_r=sent_r,
                     t_end=link.t, n_switches=n_switches)


def throughput_mev_s(res: SimResult) -> torch.Tensor:
    """Delivered events per second, in MEvents/s (float32)."""
    n = res.sent_l + res.sent_r
    return torch.where(res.t_end > 0, 1e3 * n / res.t_end, 0.0)


def energy_pj(res: SimResult, timing: LinkTiming = PAPER_TIMING):
    return (res.sent_l + res.sent_r) * timing.e_event_pj


def saturated_onedir(n_events: int = 4096, **kw) -> SimResult:
    """Fig. 7 condition: a saturated stream in one direction (starting
    as RX, so the trace opens with the reversal the paper shows)."""
    return simulate(torch.zeros(n_events, dtype=_I32),
                    torch.zeros(0, dtype=_I32), initial_tx=0, **kw)


def alternating_bidir(n_events_per_side: int = 2048, **kw) -> SimResult:
    """Fig. 8 worst case: every event reverses the bus (ping-pong load,
    bounded-burst grant after every event)."""
    z = torch.zeros(n_events_per_side, dtype=_I32)
    kw.setdefault("max_burst", 1)
    return simulate(z, z.clone(), initial_tx=1, **kw)


__all__ = ["BIG_NS", "LinkState", "LinkStepOut", "reset_link", "link_step",
           "link_step_batch", "transact", "SimTrace", "SimResult",
           "simulate",
           "throughput_mev_s", "energy_pj", "saturated_onedir",
           "alternating_bidir", "A_IDLE", "A_HANDSHAKE", "A_TX_L",
           "A_TX_R", "RX", "TX"]
