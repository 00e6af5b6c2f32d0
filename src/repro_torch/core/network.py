"""N-chip AER fabric simulator, slot engine: the paper's link pair scaled out.

The PyTorch counterpart of the slot-engine half of the reference
``core/network.py``; its module docstring states the model (event
transport through one-shot endpoint queue slots, replication tables for
unicast and in-fabric multicast, drop / credit / on-off flow control,
link-local clocks with conservative lookahead).  This module keeps that
model bit for bit:

* setup-time planning in numpy (``_expand``, ``_prefill``, the
  replication tables, the ``BIG_NS`` clock guards), copied;
* ``_slot_step_body``: one micro-transaction over every link, as int32
  tensor ops on the engine's device;
* ``_slot_run``: the step loop — ``lax.scan`` over ``max_steps``,
  which the reference jits once, becomes, for the kernel engine on
  CUDA, a CUDA graph of ``GRAPH_STEPS`` steps captured once per run and
  replayed (a Python loop of the same static-carry step on the CPU, and
  a plain host loop for ``engine="reference"``); no step reads a value
  back to the host or copies one to the device;
* ``_slot_run_multistep``: ``kernel="multistep"`` — the step loop in
  chunks of ``chunk`` micro-transactions over the packed carry of
  ``_pack_slot_state``, one ``kernels.ops.fabric_queue_multistep`` call
  per chunk (one launch of the Hopper kernel that carries the whole
  step on CUDA, a loop of ``_slot_step_body`` on the CPU).

Engines (``simulate_fabric(engine=...)`` / ``fabric.EngineSpec``):

``"reference"``
    The step's queue scan and pop/append go to the plain-PyTorch
    versions in ``kernels/ref.py`` on whatever device the run uses —
    the semantics oracle, and the only way to the plain path on the
    card.
``"pallas"`` (what ``"auto"`` means for now)
    The same step with the queue scan and the pop/append scatter
    dispatched through ``kernels/ops.py``: on CUDA the hand-written
    Hopper kernels of ``kernels/fabric_queue.py`` (two launches per
    micro-transaction, replayed from a captured CUDA graph), on the CPU
    their plain versions.  With
    ``kernel="multistep"`` the whole step runs inside one kernel launch
    per chunk of steps instead.  The name is kept for parity with the
    reference package, whose ``"pallas"`` engine runs the same step
    over its TPU kernels.

JAX semantics that PyTorch does not share are written out at each site:
int32 sums and cumsums (PyTorch promotes them to int64), scatters with
``mode="drop"`` (masked lanes go to a scratch slot or add zero), and
duplicate-target ``.add`` scatters (dense one-hot sums).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .link import LinkTiming, PAPER_TIMING
from .protocol_sim import BIG_NS, LinkState, link_step_batch, reset_link
from .router import (AddressSpec, MulticastTable, MulticastTree,
                     RoutingTable, Topology)
from .telemetry import Telemetry, _np
from .traffic import TrafficSpec
from .transceiver import XcvrState

__all__ = ["FabricResult", "simulate_fabric",
           "fabric_throughput_mev_s", "fabric_energy_pj", "link_energy_pj",
           "per_link_throughput_mev_s", "delivered_latencies",
           "delivery_multiset", "latency_stats", "ENGINES",
           "DEFAULT_CHUNK_SIZE", "RESULT_FIELDS", "assert_results_equal",
           "slot_carry_bytes"]

_BIG = BIG_NS
_I32 = torch.int32

#: Event-transport engines of the port (the ring engine comes later).
ENGINES = ("reference", "pallas")

#: Micro-transactions per launch of the multi-step kernel.
DEFAULT_CHUNK_SIZE = 128

#: Micro-transactions per CUDA graph replay of the per-step kernel engine.
GRAPH_STEPS = 32
#: Fewest replays for which a run captures its graph.  Capturing costs
#: about the host time of GRAPH_STEPS eager steps, and instantiating a
#: few more, so a run with room for one replay is faster left eager
#: (the break-even in PERF.md).
GRAPH_MIN_REPLAYS = 2
#: profiler range around a run's graph replays
REPLAY_RANGE = "slot_graph_replays"


class FabricResult(NamedTuple):
    delivered: torch.Tensor   # scalar int32
    injected: int             # static: expected deliveries (post-fanout)
    log_inj: torch.Tensor     # (E,) valid up to ``delivered``
    log_del: torch.Tensor
    log_dest: torch.Tensor
    sent: torch.Tensor        # (L, 2) per-link/direction transmissions
    n_switches: torch.Tensor  # (L,) direction switches per link
    t_link: torch.Tensor      # (L,) final link-local clocks
    t_end: torch.Tensor       # scalar: max over links
    drops: torch.Tensor       # scalar (subtree-weighted under multicast)
    offered: int = -1         # static: events offered pre-fanout
    telemetry: Telemetry | None = None

    @property
    def traversals(self) -> int:
        """Actual link traversals (sum of per-link transmissions)."""
        return int(_np(self.sent).astype(np.int64).sum())

    @property
    def fanout(self) -> float:
        """Expected deliveries per offered event (1.0 = pure unicast)."""
        if self.offered <= 0:
            return 1.0
        return float(self.injected) / float(self.offered)


#: FabricResult fields the engines must agree on bit for bit (log arrays
#: compared up to ``delivered`` — beyond it is scratch space).
RESULT_FIELDS = ("delivered", "log_inj", "log_del", "log_dest", "sent",
                 "n_switches", "t_link", "t_end", "drops")


def assert_results_equal(a: FabricResult, b: FabricResult, ctx: str = ""):
    """The engines' bit-exactness contract: every ``RESULT_FIELDS``
    entry and every telemetry counter, values and dtypes."""
    if a.injected != b.injected or a.offered != b.offered:
        raise AssertionError(f"{ctx}: injected/offered differ: "
                             f"{a.injected}/{a.offered} vs "
                             f"{b.injected}/{b.offered}")
    n = int(a.delivered)
    pairs = [(f, getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS]
    if a.telemetry is not None and b.telemetry is not None:
        pairs += [(f"telemetry.{f}", getattr(a.telemetry, f),
                   getattr(b.telemetry, f)) for f in Telemetry._fields]
    for name, x, y in pairs:
        x, y = _np(x), _np(y)
        if name.startswith("log"):
            x, y = x[:n], y[:n]
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{ctx}: engines disagree on {name}: "
                                 f"{x!r} != {y!r}")


# -----------------------------------------------------------------------
# Setup-time helpers (plain numpy, copied from the reference)
# -----------------------------------------------------------------------

def _check_reachable(rt: RoutingTable, src: np.ndarray, dest: np.ndarray):
    first_link = rt.next_link[src, dest]
    if np.any(first_link < 0):
        bad = np.flatnonzero(first_link < 0)[:4]
        raise ValueError(f"unreachable destinations, e.g. events {bad}: "
                         f"src={src[bad]} dest={dest[bad]}")


def _prefill(L: int, grp, t, route, inj, capacity: int,
             width: int | None = None):
    """Place injected copies into their first-hop queues.

    ``grp`` is the flat first-hop queue id (``link * 2 + side``) of each
    copy, ``route`` its route id and ``inj`` its injection time.
    ``capacity`` is the logical per-endpoint budget (raises on
    overflow); ``width`` the allocated column count (default
    ``capacity``).  Returns ``(q_time, q_dest, q_inj)`` of shape
    (L, 2, width) with ``BIG_NS`` in empty slots, and ``sizes`` (L, 2).
    """
    grp = np.asarray(grp, np.int64)
    t = np.asarray(t, np.int32)
    route = np.asarray(route, np.int32)
    inj = np.asarray(inj, np.int32)
    order = np.lexsort((np.arange(len(t)), t, grp))  # stable time order
    grp_s, t_s, route_s, inj_s = (grp[order], t[order], route[order],
                                  inj[order])
    sizes = np.bincount(grp, minlength=2 * L).astype(np.int32)
    if sizes.max(initial=0) > capacity:
        raise ValueError(f"queue capacity {capacity} < initial backlog "
                         f"{sizes.max()}; raise queue_capacity")
    if width is None:
        width = capacity
    starts = np.zeros(2 * L + 1, np.int64)
    np.cumsum(sizes, out=starts[1:2 * L + 1])
    slot = np.arange(len(t)) - starts[grp_s]
    q_time = np.full((2 * L, width), int(_BIG), np.int32)
    q_dest = np.zeros((2 * L, width), np.int32)
    q_inj = np.zeros((2 * L, width), np.int32)
    q_time[grp_s, slot] = t_s
    q_dest[grp_s, slot] = route_s
    q_inj[grp_s, slot] = inj_s
    return (q_time.reshape(L, 2, width), q_dest.reshape(L, 2, width),
            q_inj.reshape(L, 2, width), sizes.reshape(L, 2))


def _first_hop_queues(rt: RoutingTable, src, dest) -> np.ndarray:
    """Flat first-hop queue ids of unicast events."""
    return rt.next_link[src, dest] * 2 + rt.out_side[src, dest]


def _unicast_routes(topo: Topology, rt: RoutingTable):
    """(N, N, 1) out-queue / (N, N) deliver / (N, N, 1) drop-weight
    tables of the unicast route ids (route r < N = "to chip r")."""
    nl, os_ = rt.next_link, rt.out_side
    out_q = np.where(nl >= 0, nl * 2 + os_, -1).astype(np.int32)[:, :, None]
    deliver = np.eye(topo.n_chips, dtype=np.int32)
    weight = (out_q >= 0).astype(np.int32)
    return out_q, deliver, weight


def _routes_with_trees(topo: Topology, rt: RoutingTable,
                       trees: list[MulticastTree]):
    """Unicast tables stacked with one route per multicast tree
    (route id N + i): ``(out_q (N, R, K), deliver (N, R), weight (N, R,
    K))`` with K the largest in-fabric replication factor and
    ``weight`` the deliveries a drop of that out-copy forfeits."""
    N = topo.n_chips
    uq, ud, uw = _unicast_routes(topo, rt)
    K = max([1] + [t.max_out_degree for t in trees])
    R = N + len(trees)
    out_q = np.full((N, R, K), -1, np.int32)
    deliver = np.zeros((N, R), np.int32)
    weight = np.zeros((N, R, K), np.int32)
    out_q[:, :N, :1] = uq
    deliver[:, :N] = ud
    weight[:, :N, :1] = uw
    for i, t in enumerate(trees):
        r = N + i
        deliver[:, r] = t.deliver
        k_next = np.zeros(N, np.int64)
        for e in range(t.n_edges):
            if t.parent[e] < 0:
                continue   # root edges are prefill, not replication
            u, l, s, _v = (int(x) for x in t.edges[e])
            out_q[u, r, k_next[u]] = l * 2 + s
            weight[u, r, k_next[u]] = t.subtree[e]
            k_next[u] += 1
    return out_q, deliver, weight


def _expand(spec: TrafficSpec, addr: AddressSpec | None,
            mcast: MulticastTable | None):
    """Resolve packed/multicast destinations into unicast chip triples."""
    src = _np(spec.src).astype(np.int32)
    t = _np(spec.t).astype(np.int32)
    dest = _np(spec.dest).astype(np.int32)
    if addr is None:
        return src, t, dest
    is_mc = addr.is_multicast(dest)
    chip_or_tag, _ = addr.unpack(dest)
    out_s, out_t, out_d = [src[~is_mc]], [t[~is_mc]], [chip_or_tag[~is_mc]]
    if np.any(is_mc):
        if mcast is None:
            raise ValueError("multicast events but no MulticastTable")
        ms, mt, md = mcast.expand_stream(src[is_mc], t[is_mc],
                                         chip_or_tag[is_mc])
        out_s.append(ms)
        out_t.append(mt)
        out_d.append(md)
    return (np.concatenate(out_s), np.concatenate(out_t),
            np.concatenate(out_d))


def _overflow_guard(t_max: int, total_tx: int, worst_cost: int):
    """Refuse traffic that could push a clock to the ``BIG_NS``
    sentinel, by the global bound ``t_max + total_tx * worst_cost`` (the
    fallback when the routes cannot be walked)."""
    bound = int(t_max) + int(total_tx) * int(worst_cost)
    if bound >= int(_BIG):
        raise ValueError(
            f"clock overflow risk: worst-case end time {bound} ns reaches "
            f"the BIG_NS sentinel ({int(_BIG)} ns). Long-running "
            f"simulations must keep max(t) + total_hops * "
            f"{worst_cost} ns below it; rebase injection times or split "
            f"the simulation.")


def _route_link_tx(rt: RoutingTable, links: np.ndarray, src: np.ndarray,
                   dest: np.ndarray, L: int, n_chips: int):
    """Per-link transmission counts along the unicast routes; returns
    ``(counts (L,) int64, ok)`` with ``ok`` False when some walk does not
    terminate within ``n_chips - 1`` hops (a broken override table)."""
    counts = np.zeros(L, np.int64)
    c = np.asarray(src, np.int64).copy()
    dest = np.asarray(dest, np.int64)
    active = c != dest
    for _ in range(max(n_chips - 1, 0)):
        if not active.any():
            break
        l = np.where(active, rt.next_link[c, dest], -1)
        has = active & (l >= 0)
        l_g = np.maximum(l, 0)
        s_g = np.clip(np.where(has, rt.out_side[c, dest], 0), 0, 1)
        np.add.at(counts, l_g[has], 1)
        c = np.where(has, links[l_g, 1 - s_g], c)
        active = has & (c != dest)
    return counts, not bool(active.any())


def _clock_bound(t_max: int, link_tx: np.ndarray,
                 link_cost: np.ndarray) -> int:
    """``t_max + sum_l link_tx[l] * link_cost[l]``."""
    return int(t_max) + int((np.asarray(link_tx, np.int64)
                             * np.asarray(link_cost, np.int64)).sum())


def _overflow_guard_routed(t_max: int, link_tx: np.ndarray,
                           link_cost: np.ndarray):
    """Route-aware ``BIG_NS`` guard: each link is charged only the
    transmissions that cross it, at its own worst cost."""
    bound = _clock_bound(t_max, link_tx, link_cost)
    if bound >= int(_BIG):
        worst = int(np.asarray(link_cost).max(initial=1))
        raise ValueError(
            f"clock overflow risk: worst-case end time {bound} ns "
            f"(routed per-link bound) reaches the BIG_NS sentinel "
            f"({int(_BIG)} ns). Long-running simulations must keep "
            f"max(t) + sum over links of transmissions * per-link cost "
            f"(<= {worst} ns each) below it; rebase injection times or "
            f"split the simulation.")


# -----------------------------------------------------------------------
# Per-step pieces
# -----------------------------------------------------------------------

def _log_deliveries(log_inj, log_del, log_dest, log_n,
                    deliver, ev_inj, t_del, ev_dest, n_slots: int):
    """Append this step's deliveries to the packed log (order: link id),
    in place.  The logs hold ``n_slots + 1`` entries: non-delivering
    lanes (and any slot past the end — JAX's ``mode="drop"``) write the
    scratch entry ``n_slots``."""
    d32 = deliver.to(_I32)
    slot = torch.where(deliver, log_n + torch.cumsum(d32, 0, dtype=_I32)
                       - d32, n_slots).clamp_(max=n_slots).long()
    log_inj.index_put_((slot,), ev_inj)
    log_del.index_put_((slot,), t_del)
    log_dest.index_put_((slot,), ev_dest)
    return log_n + d32.sum(dtype=_I32)


def _forward_slots(forward, fq, n_ins_flat, cap: int, n_queues: int,
                   earlier):
    """Insertion slots for this step's forward copies.

    ``forward`` / ``fq`` are flat (M,) candidates in priority order
    (link-major, replica-minor), so simultaneous appends into one queue
    are ordered by (link, replica); ``earlier`` is the constant (M, M)
    mask ``j < i``.  Returns ``(fq_g, key, app, dropped)``: the clamped
    queue id, the insertion index, the copies that fit under ``cap`` and
    those that did not.
    """
    fq_m = torch.where(forward, fq, n_queues)
    before = (fq_m[None, :] == fq_m[:, None]) & earlier & forward[None, :]
    offs = before.sum(dim=1, dtype=_I32)
    fq_g = torch.where(forward, fq, 0)
    key = n_ins_flat[fq_g] + offs             # next free slot
    cap_ok = key < cap
    return fq_g, key, forward & cap_ok, forward & ~cap_ok


def _replicate(route_out, route_wt, rx_chip, ev_route, did):
    """This step's forward copies from the replication tables: flat
    (L·K,) ``(forward mask, queue id, drop weight)``, link-major."""
    out_qk = route_out[rx_chip, ev_route]                # (L, K)
    wt_k = route_wt[rx_chip, ev_route]                   # (L, K)
    fwd = (did[:, None] & (out_qk >= 0)).reshape(-1)
    return fwd, out_qk.clamp(min=0).reshape(-1), wt_k.reshape(-1)


def _flow_gate(fc_mode: int, cap: int, xon: int, occ, xoff, cand_route,
               rx_chip_cand, route_out):
    """Flow-control admission gate (see the reference): a head whose
    real downstream targets include a full queue (credit) or an xoff'd
    one (on/off) is blocked; delivery-only heads never are.  The xoff
    latch advances first (set at ``occ >= cap``, cleared at
    ``occ <= xon``).  ``fc_mode`` / ``cap`` / ``xon`` are plain ints.
    Returns ``(blocked (L, 2) bool, xoff' (L, 2) int32)``."""
    xoff2 = torch.where(occ >= cap, 1, torch.where(occ <= xon, 0, xoff))
    if fc_mode == 0:
        return torch.zeros_like(occ, dtype=torch.bool), xoff2
    tgt = route_out[rx_chip_cand, cand_route]            # (L, 2, K)
    real = tgt >= 0
    tgt_g = tgt.clamp(min=0)
    if fc_mode == 1:
        hit = occ.reshape(-1)[tgt_g] >= cap
    else:
        hit = xoff2.reshape(-1)[tgt_g] > 0
    return (real & hit).any(dim=2), xoff2


# -----------------------------------------------------------------------
# Slot engine: flat one-shot (Q, C) arrays
# -----------------------------------------------------------------------

class _SlotState(NamedTuple):
    link: LinkState           # (L,)-leaved LinkSim batch
    q_time: torch.Tensor      # (Q, C) release times; BIG_NS = empty
    q_dest: torch.Tensor      # (Q, C) route id
    q_inj: torch.Tensor       # (Q, C) original injection time
    n_ins: torch.Tensor       # (L, 2) entries ever inserted
    sent: torch.Tensor        # (L, 2) transmissions per direction
    prev_mode_l: torch.Tensor  # (L,) for switch counting
    n_sw: torch.Tensor        # (L,) mode_l transitions (excl. reset)
    log_inj: torch.Tensor     # (E + 1,) delivery log (+ scratch slot)
    log_del: torch.Tensor     # (E + 1,)
    log_dest: torch.Tensor    # (E + 1,)
    log_n: torch.Tensor       # scalar: deliveries so far
    drops: torch.Tensor       # scalar: weighted forwards lost
    busy_ns: torch.Tensor     # (L,) telemetry
    busy_steps: torch.Tensor  # (L, 2) telemetry
    q_drops: torch.Tensor     # (L, 2) telemetry
    n_pop: torch.Tensor       # (L, 2) entries ever popped
    xoff: torch.Tensor        # (L, 2) latched on/off bit
    in_stall: torch.Tensor    # (L, 2) stalled last step
    stall_steps: torch.Tensor  # (L, 2) telemetry
    credit_waits: torch.Tensor  # (L, 2) telemetry


def _slot_init(L: int, E: int, q_time, q_dest, q_inj, sizes,
               init_tx) -> _SlotState:
    """Reset-time carry on the device of ``q_time``."""
    dev = q_time.device
    link0 = reset_link(init_tx.to(dev))

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    return _SlotState(
        link=link0, q_time=q_time, q_dest=q_dest, q_inj=q_inj,
        n_ins=sizes, sent=z(L, 2), prev_mode_l=link0.xl.mode,
        n_sw=z(L), log_inj=z(E + 1), log_del=z(E + 1), log_dest=z(E + 1),
        log_n=z(), drops=z(), busy_ns=z(L), busy_steps=z(L, 2),
        q_drops=z(L, 2), n_pop=z(L, 2), xoff=z(L, 2), in_stall=z(L, 2),
        stall_steps=z(L, 2), credit_waits=z(L, 2))


def _slot_results(final: _SlotState, E: int):
    """The engine's 14-tuple result, read off the final carry."""
    return (final.log_n, final.log_inj[:E], final.log_del[:E],
            final.log_dest[:E], final.sent, final.n_sw, final.link.t,
            final.link.t.max(), final.drops, final.busy_ns,
            final.busy_steps, final.q_drops, final.stall_steps,
            final.credit_waits)


def _slot_step_body(L: int, E: int, C: int, max_burst: int,
                    scan_fn, update_fn, links, route_out, route_del,
                    route_wt, t_cycle_v, t_rev_v, t_idle_v,
                    cap: int, fc_mode: int, xon: int):
    """Build the per-micro-transaction physics ``body(s, step_i) -> s'``.

    One implementation of the slot-engine step, closed over the run's
    operands (device tensors) and plain-int scalars; ``scan_fn`` /
    ``update_fn`` are the kernel dispatchers (``engine="pallas"``) or
    the plain versions (``engine="reference"``).  ``update_fn`` and the
    delivery log write in place, so the caller must not reuse ``s``.
    """
    Q = 2 * L
    dev = links.device
    K = route_out.shape[2]
    lidx = torch.arange(L, device=dev)
    side = torch.arange(2, device=dev)[None, :]
    qids = torch.arange(Q, device=dev)[None, :]
    m = torch.arange(L * K, device=dev)
    earlier = m[None, :] < m[:, None]
    # the chip a pop over (link, side) would deliver into, both sides
    rx_chip_cand = torch.stack([links[:, 1], links[:, 0]], dim=1)
    # drop mode enforces the logical budget at append time; the stall
    # modes never discard (the physical width C always fits)
    app_cap = min(cap, C) if fc_mode == 0 else C

    def body(s: _SlotState, step_i: int) -> _SlotState:
        t_now = s.link.t                                      # (L,)

        # --- pending & next arrival per endpoint queue -----------------
        # a fresh contiguous (Q,) copy: the kernels take no strided views
        t_q = t_now[:, None].expand(L, 2).contiguous().view(Q)
        pend_q, r_min_q, nxt_q, amin_q, busy_q, route_q = scan_fn(
            s.q_time, s.q_dest, t_q)
        pend = pend_q.view(L, 2)
        busy_steps = s.busy_steps + busy_q.view(L, 2)
        r_min = r_min_q.view(L, 2)
        nxt2 = nxt_q.view(L, 2)

        # --- flow-control admission gate -------------------------------
        occ = s.n_ins - s.n_pop
        cand_route = route_q.view(L, 2)
        blocked, xoff = _flow_gate(fc_mode, cap, xon, occ, s.xoff,
                                   cand_route, rx_chip_cand, route_out)
        stalled = (pend > 0) & blocked
        stall_steps = s.stall_steps + stalled.to(_I32)
        credit_waits = s.credit_waits + (stalled & (s.in_stall == 0)).to(
            _I32)

        # --- conservative clock synchronization (see the reference) ----
        pend_b = pend > 0
        na_side = torch.where(
            pend_b, torch.where(blocked, _BIG, t_now[:, None]), nxt2)
        na = na_side.amin(dim=1)                              # (L,)
        t_next_g = torch.where(pend_b, _BIG, nxt2).amin(dim=1)
        t_next_eff = torch.minimum(t_next_g,
                                   torch.maximum(na.amin(), t_now))
        safe = r_min <= (na + t_cycle_v).amin()               # (L, 2)
        pend_safe = torch.where(safe & ~blocked, pend, 0)

        # --- one micro-transaction on every link -----------------------
        link, out = link_step_batch(
            s.link, pend_safe[:, 0], pend_safe[:, 1], t_next_eff,
            max_burst=max_burst, timing_arrays=(t_cycle_v, t_rev_v,
                                                t_idle_v))

        did = (out.tx_l + out.tx_r) > 0                       # (L,)
        did32 = did.to(_I32)
        busy_ns = s.busy_ns + torch.where(did, link.t - t_now, 0)
        tx_l = out.tx_l == 1
        send_side = (~tx_l).long()                            # (L,)
        qid = lidx * 2 + send_side
        pop_slot = amin_q[qid]
        ev_route = cand_route[lidx, send_side]   # == q_dest[qid, slot]
        # read before update_fn consumes the slot in place
        ev_inj = s.q_inj[qid, pop_slot]
        pop_q = torch.where(did, qid, Q).to(_I32)
        popped = torch.where(side == send_side[:, None], did32[:, None], 0)
        sent = s.sent + popped
        n_pop = s.n_pop + popped

        # --- deliver and/or replicate ----------------------------------
        rx_chip = torch.where(tx_l, links[:, 1], links[:, 0])
        deliver = did & (route_del[rx_chip, ev_route] > 0)
        log_n = _log_deliveries(s.log_inj, s.log_del, s.log_dest, s.log_n,
                                deliver, ev_inj, link.t, rx_chip, E)

        fwd_f, fqk_f, wt_f = _replicate(route_out, route_wt, rx_chip,
                                        ev_route, did)
        n_ins_f = s.n_ins.reshape(-1)
        fq_g, slot, app, dropped = _forward_slots(
            fwd_f, fqk_f, n_ins_f, app_cap, Q, earlier)
        fq_s = torch.where(app, fq_g, Q)         # drop non-appends
        q_time, q_dest, q_inj = update_fn(
            s.q_time, s.q_dest, s.q_inj, pop_q, pop_slot,
            fq_s, slot, link.t.repeat_interleave(K),
            ev_route.repeat_interleave(K), ev_inj.repeat_interleave(K))
        # duplicate targets accumulate: dense one-hot sums over (Q,)
        eq_q = fq_g[:, None] == qids                          # (L·K, Q)
        n_ins = (n_ins_f + (eq_q & app[:, None]).sum(dim=0, dtype=_I32)
                 ).view(L, 2)
        drop_wt = torch.where(dropped, wt_f, 0)
        drops = s.drops + drop_wt.sum(dtype=_I32)
        q_drops = s.q_drops + torch.where(eq_q, drop_wt[:, None], 0).sum(
            dim=0, dtype=_I32).view(L, 2)

        # --- switch counting (reset step excluded) ---------------------
        n_sw = s.n_sw
        if step_i > 0:
            n_sw = n_sw + (link.xl.mode != s.prev_mode_l).to(_I32)

        return _SlotState(
            link=link, q_time=q_time, q_dest=q_dest, q_inj=q_inj,
            n_ins=n_ins, sent=sent, prev_mode_l=link.xl.mode, n_sw=n_sw,
            log_inj=s.log_inj, log_del=s.log_del, log_dest=s.log_dest,
            log_n=log_n, drops=drops, busy_ns=busy_ns,
            busy_steps=busy_steps, q_drops=q_drops, n_pop=n_pop, xoff=xoff,
            in_stall=stalled.to(_I32), stall_steps=stall_steps,
            credit_waits=credit_waits)

    return body


def _graph_plan(max_steps: int, graph_steps: int,
                min_replays: int) -> tuple[int, int, int]:
    """How the per-step kernel engine runs ``max_steps`` steps:
    ``(head, replays, tail)`` — ``head`` (at most 2) eager warm-up steps,
    then ``replays`` runs of ``graph_steps`` captured steps, then
    ``tail`` eager steps, so a binding ``max_steps`` is honoured
    exactly.  Fewer than ``min_replays`` replays become eager steps."""
    head = min(max(max_steps, 0), 2)
    rest = max(max_steps, 0) - head
    replays = rest // graph_steps
    if replays < min_replays:
        replays = 0
    return head, replays, rest - replays * graph_steps


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped (nested)
    NamedTuples, rebuilt in the first one's types."""
    a = trees[0]
    if isinstance(a, tuple):
        return type(a)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _static_carry(s: _SlotState) -> _SlotState:
    """``s`` with a tensor of its own for every field (a field that
    shares its tensor with an earlier one, as ``prev_mode_l`` shares
    ``link.xl.mode``, is cloned): the carry that ``step_static``
    overwrites in place."""
    seen = set()

    def own(t):
        if id(t) in seen:
            return t.clone()
        seen.add(id(t))
        return t

    return _tree_map(own, s)


def _copy_carry(dst: _SlotState, src: _SlotState) -> None:
    """Overwrite the static carry ``dst`` with the step's result ``src``,
    field for field.  A field that the step returned unchanged (the
    planes and logs, written in place) is skipped; one that holds
    another field's static tensor is read before anything is written."""
    dst_l = _leaves(dst)
    owned = {id(d) for d in dst_l}
    pairs = [(d, v.clone() if id(v) in owned else v)
             for d, v in zip(dst_l, _leaves(src)) if v is not d]
    if pairs:
        # one multi-tensor copy, not a launch a field (all int32)
        torch._foreach_copy_([d for d, _ in pairs], [v for _, v in pairs])


def _capture_steps(step, n_steps: int, wrappers, stats: dict):
    """Capture ``n_steps`` calls of ``step`` into one CUDA graph on the
    current device; returns ``replay(n)``, which replays it ``n`` times.
    ``stats`` gets the capture and instantiate seconds, and from each
    ``replay(n)`` the host seconds it took to issue the replays
    (``replay_host_s``) and the first of them (``first_replay_host_s``,
    issued to an idle card, so no queue holds it back), and CUDA events
    recorded before and after them (``replay_events``).  A failed
    capture raises.

    Replays do not call the kernel wrappers, so their launch counts are
    kept here: the launches recorded during capture are taken back (none
    ran) and each replay adds them again."""
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        for _ in range(n_steps):
            step()
    t1 = time.perf_counter()
    graph.instantiate()
    stats.update(capture_s=t1 - t0,
                 instantiate_s=time.perf_counter() - t1)
    per_replay = [w.launches - b for w, b in zip(wrappers, before)]
    for w, b in zip(wrappers, before):
        w.launches = b

    def replay(n: int):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        t0 = time.perf_counter()
        graph.replay()
        t1 = time.perf_counter()
        for _ in range(n - 1):
            graph.replay()
        events[1].record()
        stats.update(first_replay_host_s=t1 - t0,
                     replay_host_s=time.perf_counter() - t0,
                     replay_events=tuple(events))
        for w, k in zip(wrappers, per_replay):
            w.launches += k * n

    return replay


def _slot_run(L: int, E: int, C: int, max_steps: int, max_burst: int,
              use_kernels: bool):
    """The slot-engine ``run`` for one shape signature.

    ``run(q_time, q_dest, q_inj, sizes, init_tx, links, route_out,
    route_del, route_wt, t_cycle_v, t_rev_v, t_idle_v, cap, fc_mode,
    xon)`` takes device tensors (the (Q, C) planes are updated in place)
    and plain-int flow-control scalars, steps ``max_steps`` times and
    returns the 14-tuple of ``_slot_results``.

    ``engine="reference"`` (``use_kernels=False``) loops ``body`` on the
    host.  The kernel engine runs step 0 (the one whose switches are not
    counted) through ``body``; every later step is ``step_static()``,
    which runs ``body`` on one static carry and copies the result back
    into it.  On CUDA, after step 1 has run eagerly (it loads both kernel
    libraries and every kernel module before any capture),
    ``GRAPH_STEPS`` calls of ``step_static`` are captured into a CUDA
    graph once per run and replayed; the steps left over, and every step
    of a run too short for ``GRAPH_MIN_REPLAYS`` replays, run eagerly
    (``_graph_plan``).  On the CPU the same ``step_static`` runs in a
    plain loop of the same plan.  ``run.graph`` reports the last run's
    plan and, on CUDA, what ``_capture_steps`` records.
    """
    from ..kernels import fabric_queue as kfq
    from ..kernels import ops as kops
    from ..kernels import ref as kref
    if use_kernels:
        scan_fn, update_fn = kops.fabric_queue_scan, kops.fabric_queue_update
    else:
        scan_fn, update_fn = kref.fabric_queue_scan, kref.fabric_queue_update

    def run(q_time, q_dest, q_inj, sizes, init_tx, links, route_out,
            route_del, route_wt, t_cycle_v, t_rev_v, t_idle_v, cap,
            fc_mode, xon):
        s = _slot_init(L, E, q_time, q_dest, q_inj, sizes, init_tx)
        body = _slot_step_body(
            L, E, C, max_burst, scan_fn, update_fn, links, route_out,
            route_del, route_wt, t_cycle_v, t_rev_v, t_idle_v, cap,
            fc_mode, xon)
        if not use_kernels:
            for step_i in range(max_steps):
                s = body(s, step_i)
            return _slot_results(s, E)

        graph_steps = GRAPH_STEPS
        head, replays, tail = _graph_plan(max_steps, graph_steps,
                                          GRAPH_MIN_REPLAYS)
        stats = {"graph_steps": graph_steps, "head": head,
                 "replays": replays, "tail": tail}
        run.graph = stats
        if head:
            s = body(s, 0)
        static = _static_carry(s)

        def step_static():
            _copy_carry(static, body(static, 1))

        for _ in range(head - 1):
            step_static()
        if replays:
            if q_time.device.type == "cuda":
                replay = _capture_steps(
                    step_static, graph_steps,
                    (kfq.fabric_queue_step, kfq.fabric_queue_update), stats)
            else:
                def replay(n):
                    for _ in range(n * graph_steps):
                        step_static()
            with torch.profiler.record_function(REPLAY_RANGE):
                replay(replays)
        for _ in range(tail):
            step_static()
        return _slot_results(static, E)

    run.graph = None
    return run


# -----------------------------------------------------------------------
# Multi-step slot engine (``kernel="multistep"``)
# -----------------------------------------------------------------------

#: packed-lane channel order of the multi-step carry, (16, L) int32
_MS_LANES = ("t", "last_dir", "bus_busy", "prev_tx_l", "prev_tx_r",
             "xl.mode", "xl.sw_ack", "xl.rx_p", "xl.burst",
             "xr.mode", "xr.sw_ack", "xr.rx_p", "xr.burst",
             "prev_mode_l", "n_sw", "busy_ns")
#: packed per-endpoint-side channel order, (9, L, 2) int32
_MS_SIDES = ("n_ins", "sent", "n_pop", "xoff", "in_stall",
             "stall_steps", "credit_waits", "busy_steps", "q_drops")


def _pack_slot_state(s: _SlotState):
    """``_SlotState`` -> the multi-step kernel's packed int32 carry.

    Seven contiguous tensors, in the reference's order: the three (Q, C)
    slot planes (the same tensors, not copies), a (16, L) lane plane
    (``_MS_LANES``), a (9, L, 2) side plane (``_MS_SIDES``), a
    (3, E + 1) delivery-log plane and a (2,) counter vector
    ``[log_n, drops]``.  The log plane is one column wider than the
    reference's (3, E): the port's logs keep a scratch slot at index E
    (see ``_slot_init``), so only the first E columns are compared with
    JAX or between the kernel and its plain version.
    """
    lk = s.link
    lanes = torch.stack([
        lk.t, lk.last_dir, lk.bus_busy, lk.prev_tx_l, lk.prev_tx_r,
        lk.xl.mode, lk.xl.sw_ack, lk.xl.rx_p, lk.xl.burst,
        lk.xr.mode, lk.xr.sw_ack, lk.xr.rx_p, lk.xr.burst,
        s.prev_mode_l, s.n_sw, s.busy_ns])
    sides = torch.stack([s.n_ins, s.sent, s.n_pop, s.xoff, s.in_stall,
                         s.stall_steps, s.credit_waits, s.busy_steps,
                         s.q_drops])
    logs = torch.stack([s.log_inj, s.log_del, s.log_dest])
    counters = torch.stack([s.log_n, s.drops])
    return (s.q_time, s.q_dest, s.q_inj, lanes, sides, logs, counters)


def _unpack_slot_state(carry) -> _SlotState:
    """The packed carry -> ``_SlotState`` of views into it."""
    q_time, q_dest, q_inj, lanes, sides, logs, counters = carry
    link = LinkState(
        t=lanes[0], last_dir=lanes[1], bus_busy=lanes[2],
        prev_tx_l=lanes[3], prev_tx_r=lanes[4],
        xl=XcvrState(mode=lanes[5], sw_ack=lanes[6], rx_p=lanes[7],
                     burst=lanes[8]),
        xr=XcvrState(mode=lanes[9], sw_ack=lanes[10], rx_p=lanes[11],
                     burst=lanes[12]))
    return _SlotState(
        link=link, q_time=q_time, q_dest=q_dest, q_inj=q_inj,
        n_ins=sides[0], sent=sides[1],
        prev_mode_l=lanes[13], n_sw=lanes[14],
        log_inj=logs[0], log_del=logs[1], log_dest=logs[2],
        log_n=counters[0], drops=counters[1],
        busy_ns=lanes[15], busy_steps=sides[7], q_drops=sides[8],
        n_pop=sides[2], xoff=sides[3], in_stall=sides[4],
        stall_steps=sides[5], credit_waits=sides[6])


def slot_carry_bytes(L: int, E: int, C: int) -> int:
    """Bytes of the reference's packed multi-step carry:
    ``3·(2L·C) + 16·L + 9·2L + 3·E + 2`` int32 words (the port's
    scratch log column is not counted)."""
    q = 2 * L
    words = 3 * q * C + len(_MS_LANES) * L + len(_MS_SIDES) * q + 3 * E + 2
    return 4 * words


def _multistep_consts(links, route_out, route_del, route_wt, t_cycle_v,
                      t_rev_v, t_idle_v, cap: int, fc_mode: int, xon: int):
    """The multi-step launch's read-only operands, in the reference's
    order: ``(links (L, 2), route_out (N, R, K), route_del (N, R),
    route_wt (N, R, K), timing (3, L), params (3,) = [cap, fc_mode,
    xon])``, contiguous int32 on the device of ``links``."""
    params = torch.tensor([cap, fc_mode, xon], dtype=_I32,
                          device=links.device)
    return (links, route_out, route_del, route_wt,
            torch.stack([t_cycle_v, t_rev_v, t_idle_v]), params)


def _multistep_step_fn(L: int, E: int, C: int, max_burst: int, cap: int,
                       fc_mode: int, xon: int, scan_fn, update_fn):
    """``step_fn(carry, consts, step_i) -> carry``: one micro-transaction
    of ``_slot_step_body`` on the packed carry — the step the plain
    ``ref.fabric_queue_multistep`` loops over (the CUDA kernel carries
    the same step itself).  The flow-control scalars are the plain ints
    the body branches on; they equal ``consts[5]``, which the kernel
    reads."""

    def step_fn(carry, consts, step_i: int):
        links, route_out, route_del, route_wt, timing, _params = consts
        body = _slot_step_body(L, E, C, max_burst, scan_fn, update_fn,
                               links, route_out, route_del, route_wt,
                               timing[0], timing[1], timing[2], cap,
                               fc_mode, xon)
        return _pack_slot_state(body(_unpack_slot_state(carry), step_i))

    return step_fn


def _slot_run_multistep(L: int, E: int, C: int, max_steps: int,
                        max_burst: int, chunk: int):
    """Multi-step variant of :func:`_slot_run`: the same operand contract
    and 14-tuple result, with the step loop run ``chunk`` steps per
    ``kernels.ops.fabric_queue_multistep`` call over the packed carry.

    A host loop makes ``ceil(max_steps / chunk)`` calls with ``base = 0,
    chunk, 2·chunk, ...`` (a device tensor each); the last runs
    ``min(chunk, max_steps - base)`` steps, so a binding ``max_steps``
    is honoured exactly.  Nothing is read back to the host.  On CUDA
    each call is one launch of the Hopper kernel, which updates the
    carry in place; on the CPU it loops ``_slot_step_body`` over the
    plain queue step.
    """
    from ..kernels import ops as kops
    from ..kernels import ref as kref

    def run(q_time, q_dest, q_inj, sizes, init_tx, links, route_out,
            route_del, route_wt, t_cycle_v, t_rev_v, t_idle_v, cap,
            fc_mode, xon):
        s = _slot_init(L, E, q_time, q_dest, q_inj, sizes, init_tx)
        carry = _pack_slot_state(s)
        consts = _multistep_consts(links, route_out, route_del, route_wt,
                                   t_cycle_v, t_rev_v, t_idle_v, cap,
                                   fc_mode, xon)
        step_fn = _multistep_step_fn(L, E, C, max_burst, cap, fc_mode, xon,
                                     kref.fabric_queue_scan,
                                     kref.fabric_queue_update)
        bases = torch.arange(0, max(max_steps, 0), chunk, dtype=_I32,
                             device=q_time.device)
        for i in range(bases.numel()):
            carry = kops.fabric_queue_multistep(
                carry, consts, bases[i:i + 1], step_fn=step_fn,
                chunk=chunk, max_steps=max_steps, max_burst=max_burst)
        return _slot_results(_unpack_slot_state(carry), E)

    return run


# -----------------------------------------------------------------------
# Public entry point
# -----------------------------------------------------------------------

def simulate_fabric(topo: Topology, spec: TrafficSpec, *,
                    routing: RoutingTable | None = None,
                    addr: AddressSpec | None = None, mcast=None,
                    timing: LinkTiming = PAPER_TIMING, max_burst: int = 0,
                    initial_tx: int | np.ndarray = 1,
                    max_steps: int | None = None,
                    queue_capacity: int | None = None,
                    flow_control: str = "drop", xon: int | None = None,
                    engine: str = "auto",
                    chunk_size: int = DEFAULT_CHUNK_SIZE,
                    device=None) -> FabricResult:
    """Simulate an N-chip fabric of bi-directional AER links.

    The convenience wrapper around :class:`repro_torch.core.fabric.Fabric`
    (same keywords as the reference's ``simulate_fabric``; see there).
    ``engine`` is ``"auto"`` (= ``"pallas"``), ``"pallas"`` (queue step
    through the Hopper kernels on CUDA) or ``"reference"`` (plain
    PyTorch).  ``chunk_size`` is the ring engine's steps per chunk in the
    reference; the port has no ring engine yet (ROADMAP A.6), so any
    other value than the default raises ``NotImplementedError`` rather
    than being ignored.  The multi-step kernel's chunk is set on a
    ``Fabric`` with ``EngineSpec("pallas", kernel="multistep",
    chunk_size=...)``.  ``device=None`` means CUDA and raises without it.
    """
    if chunk_size != DEFAULT_CHUNK_SIZE:
        raise NotImplementedError(
            f"simulate_fabric(chunk_size={chunk_size}) sets the ring "
            f"engine's chunk, and engine='ring' is not ported yet (ROADMAP "
            f"A.6); for kernel='multistep' pass Fabric(engine=EngineSpec("
            f"'pallas', kernel='multistep', chunk_size=...))")
    from .fabric import EngineSpec, Fabric, QueuePolicy
    fab = Fabric(topo, routing=routing, timing=timing,
                 queues=QueuePolicy(capacity=queue_capacity,
                                    max_burst=max_burst,
                                    initial_tx=initial_tx,
                                    flow=flow_control, xon=xon),
                 engine=EngineSpec(name=engine),
                 addr=addr, mcast=mcast,
                 device=device)
    return fab.run(spec, max_steps=max_steps)


# -----------------------------------------------------------------------
# Measurement roll-ups
# -----------------------------------------------------------------------

def fabric_throughput_mev_s(res: FabricResult) -> torch.Tensor:
    """Delivered events per second across the fabric, MEvents/s
    (float32, the reference's precision)."""
    return torch.where(res.t_end > 0, 1e3 * res.delivered / res.t_end, 0.0)


def per_link_throughput_mev_s(res: FabricResult) -> torch.Tensor:
    """(L,) per-link transmissions/s (both directions), MEvents/s."""
    n = res.sent.sum(dim=1, dtype=_I32)
    return torch.where(res.t_link > 0, 1e3 * n / res.t_link, 0.0)


def link_energy_pj(sent, timing: LinkTiming = PAPER_TIMING) -> float:
    """Every transmission on link ``l`` moves one event at that link's
    ``e_event_pj``; ``sent`` is (L,) or (L, 2)."""
    sent = _np(sent).astype(np.float64)
    per_link = sent.sum(axis=tuple(range(1, sent.ndim)))
    e = np.broadcast_to(np.asarray(timing.e_event_pj, np.float64),
                        per_link.shape)
    return float((per_link * e).sum())


def fabric_energy_pj(res: FabricResult,
                     timing: LinkTiming = PAPER_TIMING) -> float:
    """Total link energy of one fabric run."""
    return link_energy_pj(res.sent, timing)


def delivery_multiset(res: FabricResult) -> list:
    """Sorted (injection time, destination chip) pairs of all
    deliveries (the multicast modes must agree on it)."""
    n = int(res.delivered)
    return sorted(zip(_np(res.log_inj)[:n].tolist(),
                      _np(res.log_dest)[:n].tolist()))


def delivered_latencies(res: FabricResult) -> np.ndarray:
    """End-to-end ns latencies of the delivered events (numpy)."""
    n = int(res.delivered)
    return (_np(res.log_del)[:n] - _np(res.log_inj)[:n]).astype(np.int64)


def latency_stats(res: FabricResult) -> dict:
    """p50/p90/p99/max end-to-end latency plus delivery counters."""
    lat = delivered_latencies(res)
    base = {"delivered": int(res.delivered), "injected": res.injected,
            "offered": res.offered, "fanout": res.fanout,
            "traversals": res.traversals}
    if lat.size == 0:
        return {**base, "delivered": 0,
                "p50_ns": 0.0, "p90_ns": 0.0, "p99_ns": 0.0, "max_ns": 0}
    return {**base,
            "p50_ns": float(np.percentile(lat, 50)),
            "p90_ns": float(np.percentile(lat, 90)),
            "p99_ns": float(np.percentile(lat, 99)),
            "max_ns": int(lat.max())}
