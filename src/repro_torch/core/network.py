"""N-chip AER fabric simulator: the paper's link pair scaled out.

The PyTorch counterpart of the reference ``core/network.py``; its module
docstring states the model (event transport through endpoint queues,
replication tables for unicast and in-fabric multicast, drop / credit /
on-off flow control, link-local clocks with conservative lookahead).
This module keeps that model bit for bit:

* setup-time planning in numpy (``_expand``, ``_prefill``, the
  replication tables, the ring engine's stream quotas and shape
  buckets, the ``BIG_NS`` clock guards), copied;
* ``_slot_step_body`` and ``_ring_step_body``: one micro-transaction
  over every link of B fabric instances at once, as int32 tensor ops on
  the engine's device, every tensor with a leading instance axis (a
  solo run is B = 1; nothing couples two instances);
* ``_SlotRun``: the slot engine's loop over ``max_steps`` steps — for
  the kernel engine on CUDA a CUDA graph of ``GRAPH_STEPS`` steps
  captured once per runner and replayed by every run of its bucket (a
  Python loop of the same static-carry step on the CPU, a plain host
  loop for ``engine="reference"``);
* ``_MultistepRun``: ``kernel="multistep"`` — chunks of ``chunk``
  micro-transactions over the packed carry of ``_pack_slot_state``, one
  ``kernels.ops.fabric_queue_multistep`` call per chunk for the whole
  batch (one launch of the Hopper kernel, a block an instance, on CUDA;
  a loop of ``_slot_step_body`` on the CPU);
* ``_RingRun``: the ring engine's loop — chunks of ``chunk`` steps
  until every instance has drained (one device flag read a chunk) or
  ``max_steps`` binds, which it honours exactly; on CUDA a full chunk
  is replays of one CUDA graph of ``RING_GRAPH_STEPS`` steps, captured
  once per runner and reused by every later run of its bucket;
* ``engine_runner``: the process-wide cache of those runners, keyed by
  shape bucket, device, batch size, flow mode and burst bound, so every
  fabric whose plans land in one bucket — the per-epoch clones of an
  adaptive run among them — shares one runner and its graph (the
  counterpart of the reference's engines cached by shape).

Engines (``simulate_fabric(engine=...)`` / ``fabric.EngineSpec``):

``"ring"`` (what ``"auto"`` means, as in the reference)
    Per-endpoint release-sorted streams — the prefill plus one FIFO
    stream per in-edge of the chip — of which a step reads only the
    heads, so its work does not grow with the queue width; early exit
    once every event is delivered or dropped.  The reference has no
    Pallas kernel here, and neither has the port: the step is PyTorch
    ops, replayed from a CUDA graph on the card.
``"reference"``
    The slot step with its queue scan and pop/append in the
    plain-PyTorch versions of ``kernels/ref.py`` on whatever device the
    run uses — the semantics oracle, and the only way to the plain path
    on the card.
``"pallas"``
    The same slot step with the queue scan and the pop/append scatter
    dispatched through ``kernels/ops.py``: on CUDA the hand-written
    Hopper kernels of ``kernels/fabric_queue.py`` (two launches per
    micro-transaction for the whole batch, replayed from a captured
    CUDA graph), on the CPU their plain versions.  With
    ``kernel="multistep"`` the whole step runs inside one kernel launch
    per chunk of steps instead.  The name is kept for parity with the
    reference package, whose ``"pallas"`` engine runs the same step
    over its TPU kernels.

JAX semantics that PyTorch does not share are written out at each site:
int32 sums and cumsums (PyTorch promotes them to int64), scatters with
``mode="drop"`` (masked lanes go to a scratch slot or add zero),
duplicate-target ``.add`` scatters (``index_add_``) and the ring's
integer ``einsum`` (CUDA has no integer matrix product: an
``index_add_``).  Scalars that a step selects with ``torch.where`` are
0-d device tensors made once a run, not Python numbers, which PyTorch
would turn into a fill kernel each time.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .link import LinkTiming, PAPER_TIMING
from .protocol_sim import BIG_NS, LinkState, reset_link, transact
from .router import (AddressSpec, MulticastTable, MulticastTree,
                     RoutingTable, Topology)
from .telemetry import Telemetry, _np
from .traffic import TrafficSpec
from .transceiver import XcvrState

__all__ = ["FabricResult", "FabricBatchResult", "simulate_fabric",
           "fabric_throughput_mev_s", "fabric_energy_pj", "link_energy_pj",
           "per_link_throughput_mev_s", "delivered_latencies",
           "delivery_multiset", "latency_stats", "batch_latency_stats",
           "batch_throughput_mev_s", "ENGINES", "DEFAULT_CHUNK_SIZE",
           "RESULT_FIELDS", "assert_results_equal", "slot_carry_bytes",
           "reset_links"]

_BIG = BIG_NS
_I32 = torch.int32

#: Event-transport engines accepted by ``simulate_fabric(engine=...)``.
ENGINES = ("ring", "reference", "pallas")

#: Micro-transactions per chunk: the ring engine's steps between
#: early-exit checks (and per CUDA graph), the multi-step kernel's steps
#: per launch.
DEFAULT_CHUNK_SIZE = 128

#: Micro-transactions per CUDA graph replay of the per-step kernel engine.
GRAPH_STEPS = 32
#: Fewest replays for which a run captures its graph.  Capturing costs
#: about the host time of GRAPH_STEPS eager steps, and instantiating a
#: few more, so a run with room for one replay is faster left eager
#: (the break-even in PERF.md).
GRAPH_MIN_REPLAYS = 2
#: profiler range around a run's graph replays (both engines)
REPLAY_RANGE = "slot_graph_replays"
#: micro-transactions per CUDA graph of the ring engine: a chunk that
#: is a multiple of it replays its graph chunk / RING_GRAPH_STEPS times
#: (any other chunk is one graph)
RING_GRAPH_STEPS = 32

# Ring-engine shape buckets (the reference's): every dimension that would
# vary from cell to cell (links, chips, expected deliveries, prefill and
# stream widths, chip degree, routes, replication branches) is padded to
# a floored power of two; the logical counts travel as run operands.
# Padding is inert: dummy links have empty queues (they park forever and
# never bound the horizon), dummy slots hold BIG_NS, and results are
# trimmed back to the real sizes.
_RING_L_FLOOR = 32        # links
_RING_N_FLOOR = 64        # chips (routing-table side)
_RING_D_FLOOR = 4         # chip degree (forward streams per endpoint)
_RING_E_FLOOR = 2048      # expected deliveries (delivery-log length)
_RING_PREFILL_FLOOR = 2048  # prefill queue width
_RING_STREAM_FLOOR = 512  # forward-stream width
_RING_R_FLOOR = 64        # route ids (chips + multicast trees)
_RING_K_FLOOR = 4         # replication branch bound (out-copies per pop)


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


class FabricBatchResult(NamedTuple):
    """Results of B fabric instances run as one batched computation.

    Every tensor field is the solo :class:`FabricResult` field with a
    leading ``(B,)`` instance axis (telemetry included); ``injected`` and
    ``offered`` are (B,) numpy vectors.  ``instance(i)`` is instance
    ``i`` as an ordinary :class:`FabricResult`, bit-exact with the same
    spec run solo on the same engine, so every roll-up applies per
    instance.  ``delivered[i] + drops[i] == injected[i]`` per instance
    wherever the run drained.
    """
    delivered: torch.Tensor   # (B,) int32
    injected: np.ndarray      # (B,) expected deliveries per instance
    log_inj: torch.Tensor     # (B, E) valid up to ``delivered[i]``
    log_del: torch.Tensor     # (B, E)
    log_dest: torch.Tensor    # (B, E)
    sent: torch.Tensor        # (B, L, 2)
    n_switches: torch.Tensor  # (B, L)
    t_link: torch.Tensor      # (B, L)
    t_end: torch.Tensor       # (B,)
    drops: torch.Tensor       # (B,)
    offered: np.ndarray       # (B,) events offered pre-fanout
    telemetry: Telemetry      # (B,)-leading counters

    @property
    def n_instances(self) -> int:
        return int(self.injected.shape[0])

    def instance(self, i: int) -> FabricResult:
        """Instance ``i`` as a solo-shaped :class:`FabricResult` (logs
        trimmed to the instance's own expected delivery count)."""
        e = int(self.injected[i])
        return FabricResult(
            delivered=self.delivered[i], injected=e,
            log_inj=self.log_inj[i, :e], log_del=self.log_del[i, :e],
            log_dest=self.log_dest[i, :e], sent=self.sent[i],
            n_switches=self.n_switches[i], t_link=self.t_link[i],
            t_end=self.t_end[i], drops=self.drops[i],
            offered=int(self.offered[i]),
            telemetry=Telemetry(*(getattr(self.telemetry, f)[i]
                                  for f in Telemetry._fields)))

    def results(self) -> list[FabricResult]:
        """All instances as solo-shaped results, batch order."""
        return [self.instance(i) for i in range(self.n_instances)]


def batch_throughput_mev_s(batch: FabricBatchResult) -> torch.Tensor:
    """(B,) delivered events per second per instance, MEvents/s."""
    return torch.where(batch.t_end > 0, 1e3 * batch.delivered / batch.t_end,
                       0.0)


def batch_latency_stats(batch: FabricBatchResult) -> list[dict]:
    """Per-instance ``latency_stats`` dicts, batch order."""
    return [latency_stats(r) for r in batch.results()]


def reset_links(initial_tx, *, device=None) -> LinkState:
    """Batched ``protocol_sim.reset_link``: ``initial_tx`` (L,) ints, one
    polarity a link, gives a ``LinkState`` whose leaves are (L,) int32
    tensors on ``device`` (``None``: the CUDA card)."""
    m = torch.as_tensor(initial_tx, dtype=_I32)
    if m.dim() != 1:
        raise ValueError(f"initial_tx must be (L,), got {tuple(m.shape)}")
    return reset_link(m, device=resolve_device(device))


# -----------------------------------------------------------------------
# Setup-time helpers (plain numpy, copied from the reference)
# -----------------------------------------------------------------------

def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _check_reachable(rt: RoutingTable, src: np.ndarray, dest: np.ndarray):
    first_link = rt.next_link[src, dest]
    if np.any(first_link < 0):
        bad = np.flatnonzero(first_link < 0)[:4]
        raise ValueError(f"unreachable destinations, e.g. events {bad}: "
                         f"src={src[bad]} dest={dest[bad]}")


def _prefill(L: int, grp, t, route, inj, capacity: int,
             width: int | str | None = None):
    """Place injected copies into their first-hop queues.

    ``grp`` is the flat first-hop queue id (``link * 2 + side``) of each
    copy, ``route`` its route id and ``inj`` its injection time.
    ``capacity`` is the logical per-endpoint budget (raises on
    overflow); ``width`` the allocated column count: ``None`` =
    ``capacity`` (the slot layout), ``"auto"`` = the largest initial
    backlog bucketed to a power of two plus one always-empty pad column
    (the ring engine's prefill).  Returns ``(q_time, q_dest, q_inj)`` of
    shape (L, 2, width) with ``BIG_NS`` in empty slots, and ``sizes``
    (L, 2).
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
    if width == "auto":
        width = _pow2ceil(max(int(sizes.max(initial=1)),
                              _RING_PREFILL_FLOOR)) + 1
    elif width is None:
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


def _in_edge_ranks(topo: Topology):
    """Per-chip enumeration of delivering links: ``rank[l, side]`` is the
    index of link ``l`` among the links incident to chip
    ``topo.links[l, side]`` (id order) — the forward stream an event
    delivered over ``l`` into that chip appends to.  Returns ``(rank
    (L, 2) int32, D)`` with ``D`` the largest chip degree."""
    L = topo.n_links
    rank = np.zeros((L, 2), np.int32)
    deg = np.zeros(topo.n_chips, np.int32)
    for l, (a, b) in enumerate(topo.links):
        rank[l, 0] = deg[a]
        deg[a] += 1
        rank[l, 1] = deg[b]
        deg[b] += 1
    return rank, max(int(deg.max(initial=1)), 1)


def _stream_quota(rt: RoutingTable, links: np.ndarray, in_rank: np.ndarray,
                  src: np.ndarray, dest: np.ndarray, L: int, D: int):
    """Static per-(queue, in-edge) forward-count upper bound: every
    event's path is known at setup, so walking them counts the forwards
    each stream can ever receive (drops only shorten paths)."""
    counts = np.zeros((2 * L, D), np.int64)
    c = src.astype(np.int64).copy()
    prev_l = np.full(len(src), -1, np.int64)
    prev_rx_side = np.zeros(len(src), np.int64)
    active = c != dest
    while active.any():
        l = np.where(active, rt.next_link[c, dest], 0)
        s = np.where(active, rt.out_side[c, dest], 0)
        m = active & (prev_l >= 0)
        if m.any():
            d = in_rank[prev_l[m], prev_rx_side[m]]
            np.add.at(counts, (l[m] * 2 + s[m], d), 1)
        prev_l = np.where(active, l, prev_l)
        prev_rx_side = np.where(active, 1 - s, prev_rx_side)
        c = np.where(active, links[l, 1 - s], c)
        active = c != dest
    return counts


def _tree_stream_quota(trees: list[MulticastTree], tree_counts,
                       in_rank: np.ndarray, L: int, D: int):
    """Per-(queue, in-edge) forward-count bound of the tree routes: each
    non-root tree edge is one forward per event riding the tree, onto
    the parent edge's in-edge stream (root edges are prefill)."""
    counts = np.zeros((2 * L, D), np.int64)
    for tree, n in zip(trees, tree_counts):
        for e in range(tree.n_edges):
            p = int(tree.parent[e])
            if p < 0:
                continue
            _u, l, s, _v = (int(x) for x in tree.edges[e])
            lp, sp = int(tree.edges[p][1]), int(tree.edges[p][2])
            d = int(in_rank[lp, 1 - sp])
            counts[l * 2 + s, d] += int(n)
    return counts


def _pad_to(a: np.ndarray, shape: tuple, fill) -> np.ndarray:
    """Embed ``a`` in a ``fill``-initialized array of ``shape``."""
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(n) for n in a.shape)] = a
    return out


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
# Per-step pieces, shared by the slot and ring engines.  Every tensor
# has a leading instance axis B; queue ids are global (instance b's
# queue q is b·Q + q), so one gather, scatter or kernel launch serves
# the whole batch.
# -----------------------------------------------------------------------

class _Consts(NamedTuple):
    """0-d int32 device tensors a step selects with ``torch.where``."""
    big: torch.Tensor
    zero: torch.Tensor
    one: torch.Tensor


def _consts(dev: torch.device) -> _Consts:
    return _Consts(*(torch.tensor(v, dtype=_I32, device=dev)
                     for v in (_BIG, 0, 1)))


def _lead(x, nd: int):
    """A per-instance scalar shaped to broadcast against an nd-dim
    (B, ...) tensor: a plain int as it is, a (B,) tensor as (B, 1, ...)."""
    return x if isinstance(x, int) else x.view(-1, *(1,) * (nd - 1))


def _global_queues(route_out: torch.Tensor, n_queues: int) -> torch.Tensor:
    """(B, N, R, K) replication out-queues with instance b's ids offset
    by b·Q (-1, "no copy", kept)."""
    off = torch.arange(route_out.shape[0], dtype=_I32,
                       device=route_out.device).view(-1, 1, 1, 1)
    return torch.where(route_out >= 0, route_out + off * n_queues, -1)


def _delivery_rows(log_n, deliver, e_slot, n_slots: int, log_base):
    """This step's delivery-log rows (order: link id within an
    instance) as flat rows of a (B, n_slots + 1)-row log: row
    ``log_base + log_n + rank`` for a delivering link, the scratch row
    ``log_base + n_slots`` for the others (JAX's ``mode="drop"``).
    Returns the rows and the new ``log_n``."""
    d32 = deliver.to(_I32)
    slot = torch.where(deliver, log_n[:, None]
                       + torch.cumsum(d32, 1, dtype=_I32) - d32, e_slot)
    return (slot.clamp_(max=n_slots) + log_base,
            log_n + d32.sum(dim=1, dtype=_I32))


def _forward_slots(forward, fq, n_ins_flat, cap, sentinel, earlier, k):
    """Insertion slots for this step's forward copies.

    ``forward`` / ``fq`` are (B, M) candidates in priority order
    (link-major, replica-minor) with global queue ids, so simultaneous
    appends into one queue are ordered by (link, replica); ``earlier``
    is the constant (M, M) mask ``j < i``; ``sentinel`` a queue id no
    copy has.  Returns ``(fq_g, key, app, dropped)``: the clamped queue
    id, the insertion index, the copies that fit under ``cap`` and those
    that did not.
    """
    fq_m = torch.where(forward, fq, sentinel)
    before = (fq_m[:, None, :] == fq_m[:, :, None]) & earlier \
        & forward[:, None, :]
    offs = before.sum(dim=2, dtype=_I32)
    fq_g = torch.where(forward, fq, k.zero)
    key = n_ins_flat[fq_g] + offs             # next free slot
    cap_ok = key < _lead(cap, 2)
    return fq_g, key, forward & cap_ok, forward & ~cap_ok


def _replicate(route_out_g, route_wt, bidx, rx_chip, ev_route, did):
    """This step's forward copies from the replication tables: (B, L·K)
    ``(forward mask, global queue id, drop weight)``, link-major."""
    out_qk = route_out_g[bidx, rx_chip, ev_route]        # (B, L, K)
    wt_k = route_wt[bidx, rx_chip, ev_route]
    n = did.shape[0]
    fwd = (did[..., None] & (out_qk >= 0)).view(n, -1)
    return fwd, out_qk.clamp(min=0).view(n, -1), wt_k.view(n, -1)


def _flow_gate(fc_mode, cap, xon, occ, xoff, cand_route, rx_chip_cand,
               route_out_g, bidx, never, k):
    """Flow-control admission gate (see the reference): a head whose
    real downstream targets include a full queue (credit) or an xoff'd
    one (on/off) is blocked; delivery-only heads never are.  The xoff
    latch advances first (set at ``occ >= cap``, cleared at
    ``occ <= xon``).  ``fc_mode`` / ``cap`` / ``xon`` are plain ints
    or (B,) tensors; ``never`` is an all-False (B, L, 2) tensor, what
    drop mode returns.  Returns ``(blocked (B, L, 2) bool, xoff')``."""
    xoff2 = torch.where(occ >= _lead(cap, 3), k.one,
                        torch.where(occ <= _lead(xon, 3), k.zero, xoff))
    if isinstance(fc_mode, int) and fc_mode == 0:
        return never, xoff2
    tgt = route_out_g[bidx, rx_chip_cand, cand_route]   # (B, L, 2, K)
    real = tgt >= 0
    tgt_g = tgt.clamp(min=0)
    full = off = None
    if not isinstance(fc_mode, int) or fc_mode == 1:
        full = (real & (occ.view(-1)[tgt_g] >= _lead(cap, 4))).any(dim=3)
    if not isinstance(fc_mode, int) or fc_mode == 2:
        off = (real & (xoff2.view(-1)[tgt_g] > 0)).any(dim=3)
    if isinstance(fc_mode, int):
        return (full if fc_mode == 1 else off), xoff2
    fc3 = _lead(fc_mode, 3)
    return torch.where(fc3 == 1, full, (fc3 == 2) & off), xoff2


def _lanes(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, L) per-link values as (B, L·K) per-copy lanes (link-major)."""
    if K == 1:
        return x
    return x[..., None].expand(*x.shape, K).reshape(x.shape[0], -1)


# -----------------------------------------------------------------------
# Slot engine: flat one-shot (Q, C) arrays
# -----------------------------------------------------------------------

class _SlotState(NamedTuple):
    """The slot engine's carry; every field has a leading instance axis
    (B,) — none for a solo carry of the multi-step kernel's plain
    launch."""
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
    """Reset-time carry on the device of ``q_time``; a leading instance
    axis of the planes ((B, Q, C)) carries over to every field."""
    dev = q_time.device
    lead = tuple(q_time.shape[:-2])
    link0 = reset_link(init_tx.to(dev))

    def z(*shape):
        return torch.zeros(lead + shape, dtype=_I32, device=dev)

    return _SlotState(
        link=link0, q_time=q_time, q_dest=q_dest, q_inj=q_inj,
        n_ins=sizes.clone(), sent=z(L, 2), prev_mode_l=link0.xl.mode,
        n_sw=z(L), log_inj=z(E + 1), log_del=z(E + 1), log_dest=z(E + 1),
        log_n=z(), drops=z(), busy_ns=z(L), busy_steps=z(L, 2),
        q_drops=z(L, 2), n_pop=z(L, 2), xoff=z(L, 2), in_stall=z(L, 2),
        stall_steps=z(L, 2), credit_waits=z(L, 2))


def _slot_results(final: _SlotState, E: int):
    """The engine's 14-tuple result, read off a final (B, ...) carry."""
    return (final.log_n, final.log_inj[:, :E], final.log_del[:, :E],
            final.log_dest[:, :E], final.sent, final.n_sw, final.link.t,
            final.link.t.amax(dim=1), final.drops, final.busy_ns,
            final.busy_steps, final.q_drops, final.stall_steps,
            final.credit_waits)


def _slot_derived(links, route_out, cap, fc_mode, C: int) -> tuple:
    """The run operands the slot step reads besides the plan's, made
    from them: the replication out-queues with global queue ids, each
    (link, side)'s delivery chip and the append budget (drop mode
    enforces the logical budget ``cap`` at append time, clamped to the
    width C; the stall modes never discard, C always fits), for (B,)
    ``cap`` and a shared int or (B,) ``fc_mode``.  A runner that keeps
    its operands across runs copies these in with them."""
    if isinstance(fc_mode, int):
        app_cap = (cap.clamp(max=C) if fc_mode == 0
                   else torch.full_like(cap, C))
    else:
        app_cap = torch.where(fc_mode == 0, cap.clamp(max=C), C).to(_I32)
    return (_global_queues(route_out, 2 * links.shape[1]), links.flip(-1),
            app_cap)


def _slot_step_body(L: int, E: int, C: int, max_burst: int,
                    scan_fn, update_fn, links, route_out, route_del,
                    route_wt, t_cycle_v, t_rev_v, t_idle_v, cap, fc_mode,
                    xon, derived: tuple | None = None):
    """Build the per-micro-transaction physics ``body(s, step_i) -> s'``.

    One implementation of the slot-engine step for B instances, closed
    over the run's (B, ...) operands and its flow-control scalars (plain
    ints the instances share, or (B,) tensors); ``scan_fn`` /
    ``update_fn`` are the kernel dispatchers (``engine="pallas"``) or
    the plain versions (``engine="reference"``).  The queue scan sees
    the batch's (B·Q, C) rows and the pop/append the batch's global
    queue ids, with skipped lanes at B·Q, so each is one launch for the
    whole batch.  ``update_fn``, the delivery log and the ``n_ins`` /
    ``q_drops`` counters write in place, so the caller must not reuse
    ``s``.  ``derived`` is ``_slot_derived``'s tuple where the caller
    keeps it (a runner whose body outlives one run's operands); without
    it the body makes its own from the operands.
    """
    B = links.shape[0]
    Q = 2 * L
    dev = links.device
    K = route_out.shape[-1]
    k = _consts(dev)
    bidx = torch.arange(B, device=dev)[:, None]               # (B, 1)
    # global id of each link's side-1 queue (a pop on side 0 is one less)
    qbase1 = (bidx * Q + 2 * torch.arange(L, device=dev) + 1).to(_I32)
    # side == 1: with tx_l XOR-ed in, the one-hot of the send side
    side1 = torch.tensor([False, True], device=dev)  # torchlint: disable=TL002 (once a runner)
    m = torch.arange(L * K, device=dev)
    earlier = m[None, :] < m[:, None]
    log_base = (bidx * (E + 1)).to(_I32)
    e_slot = torch.tensor(E, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    nq = torch.tensor(B * Q, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    never = torch.zeros((B, L, 2), dtype=torch.bool, device=dev)
    if derived is None:
        derived = _slot_derived(
            links, route_out,
            torch.as_tensor(cap, dtype=_I32, device=dev).expand(B),  # torchlint: disable=TL002 (once a runner)
            fc_mode, C)
    # rx_chip_cand: the chip a pop over (link, side) would deliver into
    route_out_g, rx_chip_cand, app_cap = derived

    def body(s: _SlotState, step_i: int) -> _SlotState:
        t_now = s.link.t                                      # (B, L)
        planes = [p.view(B * Q, C) for p in (s.q_time, s.q_dest,
                                             s.q_inj)]

        # --- pending & next arrival per endpoint queue -----------------
        # a fresh contiguous (B·Q,) copy: the kernels take no strided views
        t_q = t_now[..., None].expand(B, L, 2).contiguous().view(B * Q)
        pend_q, r_min_q, nxt_q, amin_q, busy_q, route_q = scan_fn(
            planes[0], planes[1], t_q)
        pend = pend_q.view(B, L, 2)
        busy_steps = s.busy_steps + busy_q.view(B, L, 2)
        r_min = r_min_q.view(B, L, 2)
        nxt2 = nxt_q.view(B, L, 2)

        # --- flow-control admission gate -------------------------------
        occ = s.n_ins - s.n_pop
        blocked, xoff = _flow_gate(fc_mode, cap, xon, occ, s.xoff,
                                   route_q.view(B, L, 2), rx_chip_cand,
                                   route_out_g, bidx[..., None], never, k)
        stalled = (pend > 0) & blocked
        stalled32 = stalled.to(_I32)
        stall_steps = s.stall_steps + stalled32
        credit_waits = s.credit_waits + (stalled & (s.in_stall == 0)).to(
            _I32)

        # --- conservative clock synchronization (see the reference), --
        # every minimum over one instance's links
        pend_b = pend > 0
        na_side = torch.where(
            pend_b, torch.where(blocked, k.big, t_now[..., None]), nxt2)
        na = na_side.amin(dim=2)                              # (B, L)
        t_next_g = torch.where(pend_b, k.big, nxt2).amin(dim=2)
        t_next_eff = torch.minimum(
            t_next_g, torch.maximum(na.amin(dim=1, keepdim=True), t_now))
        safe = r_min <= (na + t_cycle_v).amin(dim=1)[:, None, None]
        pend_safe = torch.where(safe & ~blocked, pend, k.zero)

        # --- one micro-transaction on every link -----------------------
        link, tx_l, tx_r, _ = transact(
            s.link, pend_safe[..., 0], pend_safe[..., 1], t_next_eff,
            t_cycle_v, t_rev_v, t_idle_v, max_burst)

        did = tx_l | tx_r                                     # (B, L)
        did32 = did.to(_I32)
        busy_ns = s.busy_ns + torch.where(did, link.t - t_now, k.zero)
        qid = qbase1 - link.prev_tx_l        # the send side's, global
        pop_slot = amin_q[qid]
        ev_route = route_q[qid]                  # == q_dest[qid, slot]
        # read before update_fn consumes the slot in place
        ev_inj = planes[2][qid, pop_slot]
        pop_q = torch.where(did, qid, nq)
        popped = torch.where(tx_l[..., None] ^ side1, did32[..., None],
                             k.zero)
        sent = s.sent + popped
        n_pop = s.n_pop + popped

        # --- deliver and/or replicate ----------------------------------
        rx_chip = torch.where(tx_l, links[..., 1], links[..., 0])
        deliver = did & (route_del[bidx, rx_chip, ev_route] > 0)
        rows, log_n = _delivery_rows(s.log_n, deliver, e_slot, E, log_base)
        for log, v in ((s.log_inj, ev_inj), (s.log_del, link.t),
                       (s.log_dest, rx_chip)):
            log.view(-1).index_put_((rows,), v)

        fwd_f, fqk_f, wt_f = _replicate(route_out_g, route_wt, bidx,
                                        rx_chip, ev_route, did)
        n_ins_f = s.n_ins.view(-1)
        fq_g, slot, app, dropped = _forward_slots(
            fwd_f, fqk_f, n_ins_f, app_cap, nq, earlier, k)
        fq_s = torch.where(app, fq_g, nq)        # drop non-appends
        update_fn(planes[0], planes[1], planes[2], pop_q.view(-1),
                  pop_slot.view(-1), fq_s.view(-1), slot.view(-1),
                  _lanes(link.t, K).reshape(-1),
                  _lanes(ev_route, K).reshape(-1),
                  _lanes(ev_inj, K).reshape(-1))
        # duplicate targets accumulate (JAX's .at[].add)
        n_ins_f.index_add_(0, fq_g.view(-1), app.view(-1).to(_I32))
        drop_wt = torch.where(dropped, wt_f, k.zero)
        drops = s.drops + drop_wt.sum(dim=1, dtype=_I32)
        s.q_drops.view(-1).index_add_(0, fq_g.view(-1), drop_wt.view(-1))

        # --- switch counting (reset step excluded) ---------------------
        n_sw = s.n_sw
        if step_i > 0:
            n_sw = n_sw + (link.xl.mode != s.prev_mode_l).to(_I32)

        return _SlotState(
            link=link, q_time=s.q_time, q_dest=s.q_dest, q_inj=s.q_inj,
            n_ins=s.n_ins, sent=sent, prev_mode_l=link.xl.mode, n_sw=n_sw,
            log_inj=s.log_inj, log_del=s.log_del, log_dest=s.log_dest,
            log_n=log_n, drops=drops, busy_ns=busy_ns,
            busy_steps=busy_steps, q_drops=s.q_drops, n_pop=n_pop,
            xoff=xoff, in_stall=stalled32, stall_steps=stall_steps,
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


def _static_carry(s):
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


def _copy_carry(dst, src) -> None:
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


@contextlib.contextmanager
def _capturing(graph):
    """``torch.cuda.graph(graph)`` with Python's garbage collector run
    first and held off until the capture ends.  A fabric and its
    compiled buckets reference each other, so a dropped fabric's CUDA
    graphs are freed by the collector — and a graph freed while another
    stream captures (global capture mode) invalidates that capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


def _capture_steps(step, n_steps: int, wrappers, stats: dict):
    """Capture ``n_steps`` calls of ``step`` into one CUDA graph on the
    current device; returns ``replay(n, stats)``, which replays it ``n``
    times.  ``stats`` gets the capture and instantiate seconds, and the
    ``stats`` of each ``replay(n, stats)`` the host seconds it took to
    issue the replays (``replay_host_s``) and the first of them
    (``first_replay_host_s``, issued to an idle card, so no queue holds
    it back), and CUDA events recorded before and after them
    (``replay_events``).  A failed capture raises.

    Replays do not call the kernel wrappers, so their launch counts are
    kept here: the launches recorded during capture are taken back (none
    ran) and each replay adds them again."""
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with _capturing(graph):
        for _ in range(n_steps):
            step()
    t1 = time.perf_counter()
    graph.instantiate()
    stats.update(capture_s=t1 - t0,
                 instantiate_s=time.perf_counter() - t1)
    per_replay = [w.launches - b for w, b in zip(wrappers, before)]
    for w, b in zip(wrappers, before):
        w.launches = b

    def replay(n: int, stats: dict):
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


class _SlotRun:
    """The slot-engine runner for one shape signature.

    ``runner(q_time, q_dest, q_inj, sizes, init_tx, links, route_out,
    route_del, route_wt, t_cycle_v, t_rev_v, t_idle_v, cap, fc_mode,
    xon)`` takes B instances' device tensors, each with a leading (B,)
    axis, and flow-control scalars (plain ints the instances share, or
    (B,) tensors), steps ``max_steps`` times and returns the 14-tuple of
    ``_slot_results``.

    ``engine="reference"`` (``use_kernels=False``) loops the step body
    on the host, built anew each run.  The kernel engine keeps what its
    CUDA graph reads across runs, as ``_RingRun`` does: its first run
    keeps that run's operand tensors (``cap`` and ``xon`` as (B,)
    tensors; ``fc_mode`` too where it is per-instance), the derived ones
    of ``_slot_derived``, the body closed over them, and one static
    carry; every later run copies its operands into them.  Step 0 (the
    one whose switches are not counted) runs through the body on a reset
    carry, copied into the static one; every later step is
    ``_step_static()``, the body on the static carry with its result
    copied back.  On CUDA, after step 1 has run eagerly (it loads both
    kernel libraries and every kernel module before any capture),
    ``GRAPH_STEPS`` static steps are captured into a CUDA graph once per
    runner — by ``warm`` or by the first run with room for
    ``GRAPH_MIN_REPLAYS`` replays — and replayed by every run of the
    bucket; the steps left over, and every step of a run too short for
    those replays, run eagerly (``_graph_plan``).  On the CPU the same
    static steps run in a plain loop of the same plan.  ``stats`` is the
    last run's plan and, on CUDA, what ``_capture_steps`` records, and
    whether that run ``captured``; ``captures`` counts the runner's
    captures.  Results are copies: the next run overwrites the carry.
    """

    def __init__(self, L: int, E: int, C: int, max_steps: int,
                 max_burst: int, use_kernels: bool):
        self.dims = (L, E, C)
        self.max_steps, self.max_burst = int(max_steps), int(max_burst)
        self.use_kernels = use_kernels
        self.ops: list | None = None
        self.derived: tuple | None = None
        self.body = None
        self.static = None
        self.replay = None          # (graph steps, replay) on CUDA
        self.captures = 0
        #: capture and instantiate seconds of the runner's last capture
        self.capture_stats: dict = {}
        self.stats: dict | None = None

    def _fns(self):
        from ..kernels import ops as kops
        from ..kernels import ref as kref
        if self.use_kernels:
            return kops.fabric_queue_scan, kops.fabric_queue_update
        return kref.fabric_queue_scan, kref.fabric_queue_update

    def _bind(self, ops: tuple) -> None:
        """Keep the first run's operands (the body closes over them);
        copy later runs' into them."""
        L, E, C = self.dims
        (*tensors, cap, fc_mode, xon) = ops
        B, dev = tensors[0].shape[0], tensors[0].device
        cap, xon = (torch.as_tensor(v, dtype=_I32, device=dev).expand(B)
                    .contiguous() for v in (cap, xon))
        tensors += [cap, xon] + ([] if isinstance(fc_mode, int)
                                 else [fc_mode])
        derived = _slot_derived(tensors[5], tensors[6], cap, fc_mode, C)
        if self.ops is not None:
            torch._foreach_copy_(self.ops + list(self.derived),
                                 tensors + list(derived))
            return
        self.ops, self.derived = tensors, derived
        (_q, _d, _i, _sz, _tx, links, route_out, route_del, route_wt, tc,
         tv, ti) = tensors[:12]
        self.body = _slot_step_body(
            L, E, C, self.max_burst, *self._fns(), links, route_out,
            route_del, route_wt, tc, tv, ti, cap, fc_mode, xon,
            derived=derived)

    def _reset(self) -> None:
        """A reset carry, step 0 on it (where the run has one), copied
        into the static carry."""
        L, E, _C = self.dims
        q_time, q_dest, q_inj, sizes, init_tx = self.ops[:5]
        s = _slot_init(L, E, q_time, q_dest, q_inj, sizes, init_tx)
        if self.max_steps > 0:
            s = self.body(s, 0)
        if self.static is None:
            self.static = _static_carry(s)
        else:
            _copy_carry(self.static, s)

    def _step_static(self) -> None:
        _copy_carry(self.static, self.body(self.static, 1))

    def _replayer(self, graph_steps: int, stats: dict):
        """``replay(n, stats)``: ``n`` replays of the runner's graph of
        ``graph_steps`` static steps, captured now if it has none of
        that length (on CUDA); a loop of as many static steps on the
        CPU."""
        if self.static.q_time.device.type != "cuda":
            def loop(n: int, _stats: dict):
                for _ in range(n * graph_steps):
                    self._step_static()
            return loop
        if self.replay is None or self.replay[0] != graph_steps:
            from ..kernels import fabric_queue as kfq
            fn = _capture_steps(
                self._step_static, graph_steps,
                (kfq.fabric_queue_step, kfq.fabric_queue_update), stats)
            self.replay = (graph_steps, fn)
            self.captures += 1
            stats["captured"] = True
            self.capture_stats = {k: stats[k] for k in ("capture_s",
                                                        "instantiate_s")}
        return self.replay[1]

    def warm(self, ops: tuple) -> None:
        """The kernel engine on CUDA: load the kernels, bind ``ops`` (a
        zero-event plan), run steps 0 and 1 eagerly and capture the graph
        where this bucket's plan replays one, so a later run captures
        nothing.  The reference engine, and any engine on the CPU, have
        nothing to warm."""
        if not self.use_kernels or ops[0].device.type != "cuda":
            return
        from ..kernels import _build
        with torch.cuda.device(ops[0].device):
            _build.load("fabric_queue")
        self._bind(ops)
        self._reset()
        stats = {"captured": False}
        if self.max_steps > 1:
            self._step_static()
        g = GRAPH_STEPS
        if _graph_plan(self.max_steps, g, GRAPH_MIN_REPLAYS)[1]:
            self._replayer(g, stats)
        self.stats = stats

    def __call__(self, *ops):
        L, E, C = self.dims
        if not self.use_kernels:
            q_time, q_dest, q_inj, sizes, init_tx, *rest = ops
            s = _slot_init(L, E, q_time, q_dest, q_inj, sizes, init_tx)
            body = _slot_step_body(L, E, C, self.max_burst, *self._fns(),
                                   *rest)
            for step_i in range(self.max_steps):
                s = body(s, step_i)
            return _slot_results(s, E)
        self._bind(ops)
        graph_steps = GRAPH_STEPS
        head, replays, tail = _graph_plan(self.max_steps, graph_steps,
                                          GRAPH_MIN_REPLAYS)
        stats = {"graph_steps": graph_steps, "head": head,
                 "replays": replays, "tail": tail, "captured": False}
        self.stats = stats
        self._reset()
        for _ in range(head - 1):
            self._step_static()
        if replays:
            replay = self._replayer(graph_steps, stats)
            with torch.profiler.record_function(REPLAY_RANGE):
                replay(replays, stats)
        for _ in range(tail):
            self._step_static()
        return tuple(t.clone() for t in _slot_results(self.static, E))


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
    ``[log_n, drops]`` — each with the state's leading instance axis, if
    it has one.  The log plane is one column wider than the reference's
    (3, E): the port's logs keep a scratch slot at index E (see
    ``_slot_init``), so only the first E columns are compared with JAX
    or between the kernel and its plain version.
    """
    lk = s.link
    d = s.log_n.dim()                 # 0 solo, 1 with an instance axis
    lanes = torch.stack([
        lk.t, lk.last_dir, lk.bus_busy, lk.prev_tx_l, lk.prev_tx_r,
        lk.xl.mode, lk.xl.sw_ack, lk.xl.rx_p, lk.xl.burst,
        lk.xr.mode, lk.xr.sw_ack, lk.xr.rx_p, lk.xr.burst,
        s.prev_mode_l, s.n_sw, s.busy_ns], dim=d)
    sides = torch.stack([s.n_ins, s.sent, s.n_pop, s.xoff, s.in_stall,
                         s.stall_steps, s.credit_waits, s.busy_steps,
                         s.q_drops], dim=d)
    logs = torch.stack([s.log_inj, s.log_del, s.log_dest], dim=d)
    counters = torch.stack([s.log_n, s.drops], dim=d)
    return (s.q_time, s.q_dest, s.q_inj, lanes, sides, logs, counters)


def _unpack_slot_state(carry) -> _SlotState:
    """The packed carry -> ``_SlotState`` of views into it."""
    q_time, q_dest, q_inj, lanes, sides, logs, counters = carry
    d = counters.dim() - 1            # the channel axis
    lane, sd, lg, ct = (lanes.unbind(d), sides.unbind(d), logs.unbind(d),
                        counters.unbind(d))
    link = LinkState(
        t=lane[0], last_dir=lane[1], bus_busy=lane[2],
        prev_tx_l=lane[3], prev_tx_r=lane[4],
        xl=XcvrState(mode=lane[5], sw_ack=lane[6], rx_p=lane[7],
                     burst=lane[8]),
        xr=XcvrState(mode=lane[9], sw_ack=lane[10], rx_p=lane[11],
                     burst=lane[12]))
    return _SlotState(
        link=link, q_time=q_time, q_dest=q_dest, q_inj=q_inj,
        n_ins=sd[0], sent=sd[1],
        prev_mode_l=lane[13], n_sw=lane[14],
        log_inj=lg[0], log_del=lg[1], log_dest=lg[2],
        log_n=ct[0], drops=ct[1],
        busy_ns=lane[15], busy_steps=sd[7], q_drops=sd[8],
        n_pop=sd[2], xoff=sd[3], in_stall=sd[4],
        stall_steps=sd[5], credit_waits=sd[6])


def slot_carry_bytes(L: int, E: int, C: int) -> int:
    """Bytes of the reference's packed multi-step carry:
    ``3·(2L·C) + 16·L + 9·2L + 3·E + 2`` int32 words (the port's
    scratch log column is not counted)."""
    q = 2 * L
    words = 3 * q * C + len(_MS_LANES) * L + len(_MS_SIDES) * q + 3 * E + 2
    return 4 * words


def _multistep_consts(links, route_out, route_del, route_wt, t_cycle_v,
                      t_rev_v, t_idle_v, cap, fc_mode, xon):
    """The multi-step launch's read-only operands, in the reference's
    order: ``(links (L, 2), route_out (N, R, K), route_del (N, R),
    route_wt (N, R, K), timing (3, L), params (3,) = [cap, fc_mode,
    xon])``, contiguous int32 on the device of ``links``, each with the
    leading instance axis of ``links`` if it has one (the scalars then
    plain ints or (B,) tensors)."""
    dev = links.device
    lead = tuple(links.shape[:-2])
    params = torch.stack([torch.as_tensor(v, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
                          .expand(lead) for v in (cap, fc_mode, xon)],
                         dim=-1)
    return (links, route_out, route_del, route_wt,
            torch.stack([t_cycle_v, t_rev_v, t_idle_v], dim=-2), params)


def _multistep_step_fn(L: int, E: int, C: int, max_burst: int, cap,
                       fc_mode, xon, scan_fn, update_fn):
    """``step_fn(carry, consts, step_i) -> carry``: one micro-transaction
    of ``_slot_step_body`` on the packed carry — the step the plain
    ``ref.fabric_queue_multistep`` loops over (the CUDA kernel carries
    the same step itself).  The carry and constants may have a leading
    instance axis or not (a solo launch); the flow-control scalars are
    what the body takes (equal to ``consts[5]``, which the kernel
    reads)."""

    def step_fn(carry, consts, step_i: int):
        solo = carry[0].dim() == 2
        if solo:
            carry = tuple(t.unsqueeze(0) for t in carry)
            consts = tuple(t.unsqueeze(0) for t in consts)
        links, route_out, route_del, route_wt, timing, _params = consts
        body = _slot_step_body(L, E, C, max_burst, scan_fn, update_fn,
                               links, route_out, route_del, route_wt,
                               timing[:, 0], timing[:, 1], timing[:, 2],
                               cap, fc_mode, xon)
        # the body writes the logs and two counters in place through
        # flat views: give it contiguous fields (views of the carry
        # where they already are, copies where the carry is strided)
        s = _tree_map(torch.Tensor.contiguous, _unpack_slot_state(carry))
        out = _pack_slot_state(body(s, step_i))
        return tuple(t.squeeze(0) for t in out) if solo else out

    return step_fn


class _MultistepRun:
    """The multi-step variant of :class:`_SlotRun`: the same operand
    contract and 14-tuple result, with the step loop run ``chunk`` steps
    per ``kernels.ops.fabric_queue_multistep`` call over the packed
    carry of every instance.

    A host loop makes ``ceil(max_steps / chunk)`` calls with ``base = 0,
    chunk, 2·chunk, ...`` (a device tensor each); the last runs
    ``min(chunk, max_steps - base)`` steps, so a binding ``max_steps``
    is honoured exactly.  Nothing is read back to the host.  On CUDA
    each call is one launch of the Hopper kernel for the whole batch (a
    block an instance), which updates the carry in place; on the CPU it
    loops ``_slot_step_body`` over the plain queue step.  It holds no
    tensors and no graph between runs (``captures`` stays 0).
    """

    captures = 0
    stats = None

    def __init__(self, L: int, E: int, C: int, max_steps: int,
                 max_burst: int, chunk: int):
        self.dims = (L, E, C)
        self.max_steps, self.max_burst = int(max_steps), int(max_burst)
        self.chunk = int(chunk)

    def warm(self, ops: tuple) -> None:
        """Load the kernel (on CUDA)."""
        if ops[0].device.type == "cuda":
            from ..kernels import _build
            with torch.cuda.device(ops[0].device):
                _build.load("fabric_queue_multistep")

    def __call__(self, q_time, q_dest, q_inj, sizes, init_tx, links,
                 route_out, route_del, route_wt, t_cycle_v, t_rev_v,
                 t_idle_v, cap, fc_mode, xon):
        from ..kernels import ops as kops
        from ..kernels import ref as kref
        L, E, C = self.dims
        max_steps, chunk = self.max_steps, self.chunk
        s = _slot_init(L, E, q_time, q_dest, q_inj, sizes, init_tx)
        carry = _pack_slot_state(s)
        consts = _multistep_consts(links, route_out, route_del, route_wt,
                                   t_cycle_v, t_rev_v, t_idle_v, cap,
                                   fc_mode, xon)
        step_fn = _multistep_step_fn(L, E, C, self.max_burst, cap, fc_mode,
                                     xon, kref.fabric_queue_scan,
                                     kref.fabric_queue_update)
        bases = torch.arange(0, max(max_steps, 0), chunk, dtype=_I32,
                             device=q_time.device)
        for i in range(bases.numel()):
            carry = kops.fabric_queue_multistep(
                carry, consts, bases[i:i + 1], step_fn=step_fn,
                chunk=chunk, max_steps=max_steps, max_burst=self.max_burst)
        return _slot_results(_unpack_slot_state(carry), E)


# -----------------------------------------------------------------------
# Ring engine: release-time-sorted per-endpoint streams, O(1 + D) a step
# -----------------------------------------------------------------------

class _RingState(NamedTuple):
    """The ring engine's carry for B instances (leading axis B)."""
    link: LinkState           # (B, L)-leaved LinkSim batch
    hd: torch.Tensor          # (B, L, 2, 1 + D) stream heads: the
    #                           prefill's (its pop tie key too), then the
    #                           D forward streams'
    tl: torch.Tensor          # (B, L, 2, D) forward-stream tails
    fqs: torch.Tensor         # (rows, 4) every stream of every instance
    #                           (``_ring_rows``), packed channels: release
    #                           time, route id, injection time, tie key
    #                           (the reference slot id), so a step reads
    #                           every head with ONE gather and appends
    #                           with ONE scatter
    n_ins: torch.Tensor       # (B, L, 2) entries ever inserted
    sent: torch.Tensor        # (B, L, 2)
    prev_mode_l: torch.Tensor  # (B, L)
    n_sw: torch.Tensor        # (B, L)
    log_pk: torch.Tensor      # (B, E + 1, 3) delivery log, packed (inj,
    #                           t_del, dest); row E is scratch
    log_n: torch.Tensor       # (B,)
    drops: torch.Tensor       # (B,)
    busy_ns: torch.Tensor     # (B, L) telemetry
    busy_steps: torch.Tensor  # (B, L, 2) telemetry
    q_drops: torch.Tensor     # (B, L, 2) telemetry
    n_pop: torch.Tensor       # (B, L, 2) entries ever popped
    xoff: torch.Tensor        # (B, L, 2) latched on/off bit
    in_stall: torch.Tensor    # (B, L, 2) stalled last step
    stall_steps: torch.Tensor  # (B, L, 2) telemetry
    credit_waits: torch.Tensor  # (B, L, 2) telemetry


def _ring_rows(B: int, L: int, C0: int, D: int, Cf: int):
    """Row layout of ``_RingState.fqs``: forward stream ``g = (b·Q +
    q)·D + d`` (instance b, queue q, in-edge d) holds rows ``[g·Cf,
    (g + 1)·Cf)``; the prefill of queue ``b·Q + q`` rows ``P + (b·Q +
    q)·C0 + j``; one scratch row last.  Returns ``(P, scratch, rows)``.
    """
    Q = 2 * L
    P = B * Q * D * Cf
    scratch = P + B * Q * C0
    return P, scratch, scratch + 1


def _ring_init(L: int, E: int, C0: int, D: int, Cf: int, q0_time, q0_dest,
               q0_inj, sizes, init_tx) -> _RingState:
    """Reset-time ring carry of B instances from their (B, L, 2, C0)
    prefill planes, (B, L, 2) backlogs and (B, L) reset polarities, on
    their device; every field a tensor of its own."""
    B = q0_time.shape[0]
    dev = q0_time.device
    P, scratch, rows = _ring_rows(B, L, C0, D, Cf)
    fqs = torch.zeros((rows, 4), dtype=_I32, device=dev)
    fqs[:P, 0] = _BIG                   # empty forward slots
    fqs[scratch, 0] = _BIG
    pre = fqs[P:scratch].view(-1, C0, 4)
    for c, plane in enumerate((q0_time, q0_dest, q0_inj)):
        pre[..., c] = plane.reshape(-1, C0)
    pre[..., 3] = torch.arange(C0, dtype=_I32, device=dev)
    link0 = reset_link(init_tx.clone())

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=_I32, device=dev)

    return _RingState(
        link=link0, hd=z(L, 2, 1 + D), tl=z(L, 2, D), fqs=fqs,
        n_ins=sizes.clone(), sent=z(L, 2),
        prev_mode_l=link0.xl.mode.clone(), n_sw=z(L),
        log_pk=z(E + 1, 3), log_n=z(), drops=z(), busy_ns=z(L),
        busy_steps=z(L, 2), q_drops=z(L, 2), n_pop=z(L, 2), xoff=z(L, 2),
        in_stall=z(L, 2), stall_steps=z(L, 2), credit_waits=z(L, 2))


def _ring_derived(ops: dict, L: int) -> dict:
    """The run operands the ring step reads besides ``RING_OPERANDS``,
    made from them on their device: the replication out-queues with
    global queue ids (``route_out_g``), each (link, side)'s delivery
    chip (``rx_chip_cand``) and the append budget (``app_cap``: the
    capacity in drop mode — the stall modes are lossless and the stream
    quotas bound their storage, so BIG_NS there)."""
    fc, cap = ops.get("fc_mode", ops["fc"]), ops["cap"]
    if isinstance(fc, int):
        app_cap = cap.clone() if fc == 0 else torch.full_like(cap, _BIG)
    else:
        app_cap = torch.where(fc == 0, cap, _BIG)
    return {"route_out_g": _global_queues(ops["route_out"], 2 * L),
            "rx_chip_cand": ops["links"].flip(-1), "app_cap": app_cap}


def _ring_step_body(L: int, E: int, C0: int, D: int, Cf: int, ops: dict,
                    fc_mode, max_burst):
    """Build the ring engine's micro-transaction ``body(s, step_i)``.

    One implementation for B instances, closed over their (B, ...)
    operands ``ops`` (``RING_OPERANDS`` and ``_ring_derived``, all
    dimensions the bucketed ones; ``cap`` / ``xon`` (B,) tensors) and
    the flow mode and burst bound (plain ints the instances share, or
    (B,) tensors).  The reference's step (``_ring_run.body``) in
    PyTorch ops: per endpoint the 1 + D stream heads give "any released
    entry", the earliest released release, the earliest future arrival
    and the (release, key) winner — no O(C) scan; the pop advances one
    head, the forwards append at their streams' tails.  The body reads
    ``ops`` only when it runs, so new values copied into them reach a
    captured graph.  ``fqs``, ``log_pk``, ``tl``, ``n_ins`` and
    ``q_drops`` are written in place, so the caller must not reuse
    ``s``.
    """
    links, route_del, route_wt, in_rank = (
        ops[n] for n in ("links", "route_del", "route_wt", "in_rank"))
    t_cycle_v, t_rev_v, t_idle_v = (ops[n] for n in ("t_cycle", "t_rev",
                                                     "t_idle"))
    cap, xon, app_cap = ops["cap"], ops["xon"], ops["app_cap"]
    route_out_g, rx_chip_cand = ops["route_out_g"], ops["rx_chip_cand"]
    B = links.shape[0]
    Q = 2 * L
    K = route_out_g.shape[-1]
    M = L * K
    dev = links.device
    k = _consts(dev)
    P, scratch, rows = _ring_rows(B, L, C0, D, Cf)
    if rows >= 2**31 or B * (E + 1) >= 2**31:
        raise ValueError(f"ring engine: {rows} stream rows for {B} "
                         f"instances; int32 row ids cannot address them")
    bidx = torch.arange(B, device=dev)[:, None]               # (B, 1)
    qg = (bidx * Q + torch.arange(Q, device=dev)).view(B, L, 2)
    # first row of each of an endpoint's 1 + D streams
    sbase = torch.cat([(P + qg * C0)[..., None],
                       (qg[..., None] * D + torch.arange(D, device=dev))
                       * Cf], dim=-1).to(_I32)
    jidx = torch.arange(1 + D, device=dev)
    side1 = torch.tensor([False, True], device=dev)  # torchlint: disable=TL002 (once a runner)
    m = torch.arange(M, device=dev)
    earlier = m[None, :] < m[:, None]
    log_base = (bidx * (E + 1)).to(_I32)
    e_slot = torch.tensor(E, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    no_key = torch.tensor(2**31 - 1, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    nq = torch.tensor(B * Q, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    scratch_row = torch.tensor(scratch, dtype=_I32, device=dev)  # torchlint: disable=TL002 (once a runner)
    never = torch.zeros((B, L, 2), dtype=torch.bool, device=dev)

    def body(s: _RingState, step_i: int) -> _RingState:
        t_now = s.link.t                                      # (B, L)

        # --- O(1 + D) queue reads: stream heads only --------------------
        heads = s.fqs[sbase + s.hd]                           # (B,L,2,1+D,4)
        cand_t = heads[..., 0]
        rel = cand_t <= t_now[..., None, None]
        pend_side = rel.any(dim=3)                            # (B, L, 2)
        r_min = torch.where(rel, cand_t, k.big).amin(dim=3)
        nxt = torch.where(rel, k.big, cand_t).amin(dim=3)
        # the (release, key) lexicographic minimum over released heads,
        # both sides (keys are unique slot ids per queue; argmin takes
        # the first of equal values, the reference's lowest-slot rule)
        tie = rel & (cand_t == r_min[..., None])
        best = torch.where(tie, heads[..., 3], no_key).argmin(dim=3)
        best_head = heads.gather(
            3, best[..., None, None].expand(B, L, 2, 1, 4))[:, :, :, 0]

        # --- flow-control admission gate -------------------------------
        occ = s.n_ins - s.n_pop
        blocked, xoff = _flow_gate(fc_mode, cap, xon, occ, s.xoff,
                                   best_head[..., 1], rx_chip_cand,
                                   route_out_g, bidx[..., None], never, k)
        stalled = pend_side & blocked
        stalled32 = stalled.to(_I32)
        stall_steps = s.stall_steps + stalled32
        credit_waits = s.credit_waits + (stalled & (s.in_stall == 0)).to(
            _I32)

        # --- conservative clock synchronization (see the slot body) ----
        na_side = torch.where(
            pend_side, torch.where(blocked, k.big, t_now[..., None]), nxt)
        na = na_side.amin(dim=2)                              # (B, L)
        t_next_g = torch.where(pend_side, k.big, nxt).amin(dim=2)
        t_next_eff = torch.minimum(
            t_next_g, torch.maximum(na.amin(dim=1, keepdim=True), t_now))
        safe = r_min <= (na + t_cycle_v).amin(dim=1)[:, None, None]
        pend_safe = (pend_side & safe & ~blocked).to(_I32)

        # --- one micro-transaction on every link -----------------------
        link, tx_l, tx_r, _ = transact(
            s.link, pend_safe[..., 0], pend_safe[..., 1], t_next_eff,
            t_cycle_v, t_rev_v, t_idle_v, max_burst)
        did = tx_l | tx_r                                     # (B, L)
        did32 = did.to(_I32)
        busy_steps = s.busy_steps + pend_side.to(_I32)
        busy_ns = s.busy_ns + torch.where(did, link.t - t_now, k.zero)

        # --- pop the send side's head, return its credit ---------------
        # (tx_l: the link sends on side 0, into its side-1 chip)
        ev = torch.where(tx_l[..., None], best_head[:, :, 0],
                         best_head[:, :, 1])                  # (B, L, 4)
        ev_route, ev_inj = ev[..., 1], ev[..., 2]
        best_s = torch.where(tx_l, best[:, :, 0], best[:, :, 1])
        oh_side = tx_l[..., None] ^ side1                     # (B, L, 2)
        hd = s.hd + (oh_side[..., None] & (jidx == best_s[..., None, None])
                     & did[..., None, None]).to(_I32)
        popped = torch.where(oh_side, did32[..., None], k.zero)
        sent = s.sent + popped
        n_pop = s.n_pop + popped

        # --- deliver and/or replicate ----------------------------------
        rx_chip = torch.where(tx_l, links[..., 1], links[..., 0])
        deliver = did & (route_del[bidx, rx_chip, ev_route] > 0)
        # consecutive log rows from log_n (the slot engines' rule); the
        # rows past log_n stay zero, as the reference's overhang rows do
        log_rows, log_n = _delivery_rows(s.log_n, deliver, e_slot, E,
                                         log_base)
        s.log_pk.view(-1, 3).index_put_(
            (log_rows,), torch.stack([ev_inj, link.t, rx_chip], dim=-1))

        # --- forward append: tails of the delivering link's streams ----
        # all K copies of one pop land at one chip on K distinct
        # out-queues, so the active (queue, in-edge) streams are unique
        fwd_f, fqk_f, wt_f = _replicate(route_out_g, route_wt, bidx,
                                        rx_chip, ev_route, did)
        fq_g, key, app, dropped = _forward_slots(
            fwd_f, fqk_f, s.n_ins.view(-1), app_cap, nq, earlier, k)
        d_ins = torch.where(tx_l, in_rank[..., 1], in_rank[..., 0])
        stream = fq_g * D + _lanes(d_ins, K)                  # global
        tail = s.tl.view(-1)[stream]
        s.fqs.index_put_(
            (torch.where(app, stream * Cf + tail, scratch_row),),
            torch.stack([_lanes(link.t, K), _lanes(ev_route, K),
                         _lanes(ev_inj, K), key], dim=-1))
        # counter bumps: duplicate targets accumulate (an index_add_, for
        # the reference's one-hot sums and integer einsum)
        app32 = app.to(_I32).view(-1)
        s.n_ins.view(-1).index_add_(0, fq_g.view(-1), app32)
        s.tl.view(-1).index_add_(0, stream.view(-1), app32)
        drop_wt = torch.where(dropped, wt_f, k.zero)
        drops = s.drops + drop_wt.sum(dim=1, dtype=_I32)
        s.q_drops.view(-1).index_add_(0, fq_g.view(-1), drop_wt.view(-1))

        # --- switch counting (reset step excluded) ---------------------
        n_sw = s.n_sw
        if step_i > 0:
            n_sw = n_sw + (link.xl.mode != s.prev_mode_l).to(_I32)

        return _RingState(
            link=link, hd=hd, tl=s.tl, fqs=s.fqs, n_ins=s.n_ins, sent=sent,
            prev_mode_l=link.xl.mode, n_sw=n_sw, log_pk=s.log_pk,
            log_n=log_n, drops=drops, busy_ns=busy_ns,
            busy_steps=busy_steps, q_drops=s.q_drops, n_pop=n_pop,
            xoff=xoff, in_stall=stalled32, stall_steps=stall_steps,
            credit_waits=credit_waits)

    return body


#: the ring runner's operands, in ``_RingRun.run`` order
RING_OPERANDS = ("q0_time", "q0_dest", "q0_inj", "sizes", "init_tx",
                 "links", "route_out", "route_del", "route_wt", "in_rank",
                 "t_cycle", "t_rev", "t_idle", "cap", "xon", "real_e",
                 "fc_mode", "max_burst")


class _RingRun:
    """The ring engine's loop for B instances of one shape bucket.

    ``run(ops, max_steps)`` takes the bucket-padded operands (a dict of
    ``RING_OPERANDS``, device tensors with a leading (B,) axis; the
    flow-control mode and burst bound are tensors only when the runner
    was made for per-instance values, ``fc_mode`` / ``max_burst`` given
    to the constructor as ``None``) and returns the reference's 13-tuple
    (logs cut to the bucket's E).

    Step 0 (whose switches are not counted) runs eagerly; then chunks of
    ``chunk`` steps, each followed by one host read of the device flag
    "some instance has ``delivered + drops < injected``" until it clears
    or ``max_steps`` is reached.  A chunk that ``max_steps`` cuts short
    runs exactly the steps left, eagerly, so a binding bound stays
    bit-exact; post-completion steps are exact no-ops, so where the flag
    is read never changes a result.  Every step after step 0 is
    ``step_static()``: the body on one static carry, its result copied
    back.  On CUDA each full chunk is replays of one CUDA graph of
    ``RING_GRAPH_STEPS`` static steps (of ``chunk`` steps where the chunk
    is not a multiple of it), captured the first time a run needs it (or
    by ``warm()``) and kept with the runner's operand and carry tensors,
    into which every later run copies its own; on the CPU the same
    static steps run in a loop.  A failed capture raises.  ``stats``
    describes the last run.
    """

    def __init__(self, L: int, E: int, C0: int, D: int, Cf: int,
                 chunk: int, fc_mode, max_burst):
        self.dims = (L, E, C0, D, Cf)
        self.chunk = int(chunk)
        self.fc_mode, self.max_burst = fc_mode, max_burst
        self.ops = None
        self.body = None
        self.carry = None
        self.graph = None
        self.captures = 0
        #: capture and instantiate seconds of the runner's last capture
        self.capture_stats: dict = {}
        self.stats: dict = {}

    def _bind(self, ops: dict) -> None:
        """The first run keeps its operand tensors (the body closes over
        them); later runs copy theirs into them."""
        if self.ops is None:
            # the two scalars travel as operands only when per-instance
            want = RING_OPERANDS[:-2] + tuple(
                n for n, v in (("fc_mode", self.fc_mode),
                               ("max_burst", self.max_burst)) if v is None)
            missing = [n for n in want if n not in ops]
            if missing:
                raise ValueError(f"ring runner: missing operands {missing}")
            self.ops = dict(ops)
            o = self.ops
            L, E, C0, D, Cf = self.dims
            o.update(_ring_derived(dict(o, fc=self.fc_mode), L))
            fc = o["fc_mode"] if self.fc_mode is None else self.fc_mode
            mb = (o["max_burst"][:, None] if self.max_burst is None
                  else self.max_burst)
            self.body = _ring_step_body(L, E, C0, D, Cf, o, fc, mb)
            return
        ops = dict(ops)
        ops.update(_ring_derived(dict(ops, fc=self.fc_mode), self.dims[0]))
        names = [n for n in self.ops if n in ops]
        torch._foreach_copy_([self.ops[n] for n in names],
                             [ops[n] for n in names])

    def _reset(self) -> _RingState:
        L, E, C0, D, Cf = self.dims
        o = self.ops
        init = _ring_init(L, E, C0, D, Cf, o["q0_time"], o["q0_dest"],
                          o["q0_inj"], o["sizes"], o["init_tx"])
        if self.carry is None:
            self.carry = _static_carry(init)
        else:
            _copy_carry(self.carry, init)
        return self.carry

    def _step_static(self) -> None:
        _copy_carry(self.carry, self.body(self.carry, 1))

    def _graph_steps(self) -> int:
        g = RING_GRAPH_STEPS
        return g if self.chunk % g == 0 else self.chunk

    def _capture(self, stats: dict) -> None:
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with _capturing(self.graph):
            for _ in range(self._graph_steps()):
                self._step_static()
        t1 = time.perf_counter()
        self.graph.instantiate()
        self.captures += 1
        self.capture_stats = {"capture_s": t1 - t0,
                              "instantiate_s": time.perf_counter() - t1}
        stats.update(captured=True, **self.capture_stats)

    def warm(self, ops: dict) -> None:
        """Bind ``ops`` (a zero-event plan) and, on CUDA, run step 0
        eagerly (it loads every kernel module) and capture the chunk."""
        self._bind(ops)
        self._reset()
        _copy_carry(self.carry, self.body(self.carry, 0))
        if self.graph is None and self.carry.fqs.device.type == "cuda":
            self._capture(self.stats)

    def run(self, ops: dict, max_steps: int):
        self._bind(ops)
        st = self._reset()
        cuda = st.fqs.device.type == "cuda"
        real_e = self.ops["real_e"]
        stats = {"chunk": self.chunk, "graph_steps": self._graph_steps(),
                 "steps": 0, "chunks": 0, "replays": 0, "host_syncs": 0,
                 "captured": False}
        self.stats = stats

        def pending() -> bool:
            stats["host_syncs"] += 1
            return bool(((st.log_n + st.drops) < real_e).any())

        base = 0
        if max_steps > 0 and pending():
            _copy_carry(st, self.body(st, 0))
            base = 1
            events = None
            while base < max_steps:
                n = min(self.chunk, max_steps - base)
                if cuda and n == self.chunk:
                    if self.graph is None:
                        self._capture(stats)
                    if events is None:
                        events = [torch.cuda.Event(enable_timing=True)
                                  for _ in range(2)]
                        events[0].record()
                        t0 = time.perf_counter()
                    with torch.profiler.record_function(REPLAY_RANGE):
                        for _ in range(self.chunk // stats["graph_steps"]):
                            self.graph.replay()
                            stats["replays"] += 1
                    events[1].record()
                else:
                    for _ in range(n):
                        self._step_static()
                base += n
                stats["chunks"] += 1
                if base < max_steps and not pending():
                    break
            if events is not None:
                stats.update(replay_events=tuple(events),
                             replay_host_s=time.perf_counter() - t0)
        stats["steps"] = base
        E = self.dims[1]
        # copies: the next run of this runner overwrites the carry
        return tuple(t.clone() for t in (
            st.log_n, st.log_pk[:, :E, 0], st.log_pk[:, :E, 1],
            st.log_pk[:, :E, 2], st.sent, st.n_sw, st.link.t, st.drops,
            st.busy_ns, st.busy_steps, st.q_drops, st.stall_steps,
            st.credit_waits))


# -----------------------------------------------------------------------
# Engine runners shared by shape bucket
# -----------------------------------------------------------------------

#: Every engine runner of the process, by ``engine_runner``'s key.  Like
#: the reference's engines (``functools.lru_cache(maxsize=None)`` by
#: shape) it is never trimmed.  A ring or per-step kernel runner holds
#: its operand and carry tensors — for ring-16 at B = 1, 5.9 MB of
#: padded streams and planes on the ring engine, 0.3 MB of (2L, C)
#: planes, tables and logs on the per-step engine — and, on the card,
#: one captured CUDA graph of ``RING_GRAPH_STEPS`` / ``GRAPH_STEPS``
#: steps with its memory pool; ``engine="reference"`` and multi-step
#: runners hold nothing between runs.
_RUNNERS: dict[tuple, object] = {}


def _new_runner(bucket: tuple, fc_mode, max_burst):
    """The runner a bucket's plans run on (``fc_mode`` / ``max_burst``
    None: per-instance operands)."""
    if bucket[0] == "ring":
        _, Lp, _Np, Ep, C0, Dp, Cf, _Rp, _Kp, chunk = bucket
        return _RingRun(Lp, Ep, C0, Dp, Cf, chunk, fc_mode, max_burst)
    eng, L, E, C, max_steps, mb, _R, _K, kern, chunk = bucket
    if kern == "multistep":
        return _MultistepRun(L, E, C, max_steps, mb, chunk)
    return _SlotRun(L, E, C, max_steps, mb, eng == "pallas")


def engine_runner(bucket: tuple, device: torch.device, n_inst: int,
                  fc_mode, max_burst, n_chips: int):
    """The process-wide runner for ``n_inst`` instances of ``bucket`` on
    ``device`` whose flow mode and burst bound are ``fc_mode`` /
    ``max_burst`` (a shared int, or a tuple of per-instance values,
    which the runner takes as operands: one runner for every such
    tuple).  The slot engines' key adds ``n_chips``, the leading side of
    their replication tables, which their bucket does not fix.  Made on
    first use; every later run of the key copies its operands into it
    (``_RingRun``, ``_SlotRun``)."""
    key = (bucket, device, n_inst,
           fc_mode if isinstance(fc_mode, int) else None,
           max_burst if isinstance(max_burst, int) else None)
    if bucket[0] != "ring":
        key += (n_chips,)
    runner = _RUNNERS.get(key)
    if runner is None:
        runner = _RUNNERS[key] = _new_runner(bucket, key[3], key[4])
    return runner


def runner_count(bucket: tuple, device: torch.device, *,
                 batched: bool) -> int:
    """Runners the process holds for ``bucket`` on ``device``: solo ones
    (one instance) or, with ``batched``, those of batches, across every
    batch size, flow mode and burst bound."""
    return sum(1 for k in _RUNNERS
               if k[0] == bucket and k[1] == device
               and (k[2] > 1) == batched)


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
    ``engine`` is ``"auto"`` (= ``"ring"``), ``"ring"`` (stream heads,
    early exit), ``"pallas"`` (slot engine, queue step through the
    Hopper kernels on CUDA) or ``"reference"`` (slot engine, plain
    PyTorch); all are bit-exact.  ``chunk_size`` is the ring engine's
    steps between early-exit checks (and per CUDA graph); the
    multi-step kernel's chunk is set on a ``Fabric`` with
    ``EngineSpec("pallas", kernel="multistep", chunk_size=...)``.
    ``device=None`` means CUDA and raises without it.
    """
    from .fabric import EngineSpec, Fabric, QueuePolicy
    fab = Fabric(topo, routing=routing, timing=timing,
                 queues=QueuePolicy(capacity=queue_capacity,
                                    max_burst=max_burst,
                                    initial_tx=initial_tx,
                                    flow=flow_control, xon=xon),
                 engine=EngineSpec(name=engine, chunk_size=chunk_size),
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
