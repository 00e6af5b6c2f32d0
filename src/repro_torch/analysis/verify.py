"""Fabric pre-flight verifier: static proofs before any engine step.

The PyTorch port's counterpart of the reference ``analysis/verify.py``,
finding for finding and message for message.  Under credit or on/off
backpressure a pop stalls while its downstream queue is full, so stall
chains follow the *channel-dependency graph* (CDG) of the route set,
and this module applies the Dally–Seitz criterion to it statically:

* **Channels** are the engines' flat endpoint queues, ``link * 2 +
  out_side`` (2L of them) — the queue ids ``network._prefill`` and the
  replication tables use.
* **CDG edges** ``q1 -> q2`` exist when an event popped from ``q1``
  forwards into ``q2``: consecutive channels of every terminating
  unicast route, plus parent-edge -> child-edge pairs of every
  in-fabric multicast tree branching.
* **Acyclic CDG ⇒ deadlock-free** for the stall modes: every wait
  chain descends a DAG and ends at a delivery-only pop, which is never
  gated.
* A cyclic CDG is a *hazard*: a cycle locks up only if every channel on
  it is full at once, so a cycle crossing a channel whose worst-case
  insertions (prefill + forwards, known from the routes) stay below the
  queue capacity can never engage.  With a traffic spec the verifier
  grades cycles by this *saturability*: an all-saturable cycle is an
  error, any other a hazard with the slack named.

``verify_fabric`` (``Fabric.verify(spec)``) adds route termination
(unicast walks and multicast replication, over
``router.route_step_tables``), reachability of the spec's destinations,
replication-table completeness, drop-mode prefill overflow and the int32
clock budget against the ``BIG_NS`` sentinel.  It is host code: numpy
on the fabric's tables and the spec's arrays, nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.network import (_BIG, _clock_bound, _expand, _first_hop_queues,
                            _route_link_tx)
from ..core.router import (RoutingTable, Topology, find_route_cycles,
                           route_step_tables)
from ..core.telemetry import _np

__all__ = ["ChannelGraph", "Finding", "VerifyReport", "channel_graph",
           "describe_channel", "verify_fabric"]


def describe_channel(topo: Topology, q: int) -> str:
    """Human name of flat endpoint-queue ``q``: ``L<link>:<from>-><to>``."""
    link, side = int(q) // 2, int(q) % 2
    a = int(topo.links[link, side])
    b = int(topo.links[link, 1 - side])
    return f"L{link}:{a}->{b}"


@dataclass(frozen=True)
class ChannelGraph:
    """The channel-dependency graph over ``2 * n_links`` flat queues.

    ``edges[(m, 2)]`` — directed dependencies ``q1 -> q2`` (an event
    popped from ``q1`` appends into ``q2``), deduplicated and sorted so
    the graph (and every verdict derived from it) is deterministic.
    """
    topo: Topology
    edges: np.ndarray  # (m, 2) int32

    @property
    def n_channels(self) -> int:
        return 2 * self.topo.n_links

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def restrict(self, keep: np.ndarray) -> "ChannelGraph":
        """Subgraph induced on the channels where ``keep`` is True."""
        keep = np.asarray(keep, bool)
        if not len(self.edges):
            return self
        m = keep[self.edges[:, 0]] & keep[self.edges[:, 1]]
        return ChannelGraph(self.topo, self.edges[m])

    def find_cycle(self) -> list[int] | None:
        """One explicit channel cycle, or ``None`` when the CDG is
        acyclic (the Dally–Seitz certificate).

        Kahn's algorithm peels nodes with no remaining in-edges; what
        survives is exactly the set of channels on or downstream of a
        cycle.  A DFS inside the survivor subgraph then recovers one
        concrete cycle to *name* in refusals — the deterministic
        lowest-id back edge, so error messages are stable across runs.
        """
        if not len(self.edges):
            return None
        n = self.n_channels
        e = self.edges
        indeg = np.bincount(e[:, 1], minlength=n)
        alive = np.ones(n, bool)
        frontier = list(np.flatnonzero(indeg == 0))
        while frontier:
            u = frontier.pop()
            alive[u] = False
            for v in e[e[:, 0] == u, 1]:
                indeg[v] -= 1
                if indeg[v] == 0 and alive[v]:
                    frontier.append(int(v))
        if not alive.any():
            return None
        # adjacency restricted to surviving nodes, sorted for determinism
        adj: dict[int, list[int]] = {}
        for q1, q2 in e[alive[e[:, 0]] & alive[e[:, 1]]].tolist():
            adj.setdefault(q1, []).append(q2)
        for lst in adj.values():
            lst.sort()
        color = {}  # 0 = on stack, 1 = done
        for start in sorted(adj):
            if start in color:
                continue
            stack = [(start, iter(adj.get(start, ())))]
            color[start] = 0
            path = [start]
            while stack:
                u, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    stack.pop()
                    path.pop()
                    color[u] = 1
                    continue
                if color.get(nxt) == 0:       # back edge: cycle found
                    return path[path.index(nxt):]
                if nxt not in color:
                    color[nxt] = 0
                    path.append(nxt)
                    stack.append((nxt, iter(adj.get(nxt, ()))))
        return None  # pragma: no cover - Kahn said a cycle exists

    def describe_cycle(self, cycle: list[int]) -> str:
        names = [describe_channel(self.topo, q) for q in cycle]
        return " -> ".join(names + [names[0]]) if names else ""


def channel_graph(topo: Topology, rt: RoutingTable, trees=(),
                  exclude_pairs: np.ndarray | None = None) -> ChannelGraph:
    """Build the CDG from the routes (and tree branchings) themselves.

    Walks all (chip, dest) unicast pairs at once over the shared
    ``router.route_step_tables`` traversal, collecting every
    consecutive-channel pair; ``exclude_pairs`` (an ``(n, 2)`` array of
    (chip, dest)) removes non-terminating walks — their channels are
    quarantined, not dependencies.  Each in-fabric multicast tree adds
    one edge per non-root branching (parent edge's channel -> child
    edge's channel); root edges are injection prefill, which consumes no
    upstream pop and therefore adds no dependency.
    """
    n = topo.n_chips
    step_to, step_q = route_step_tables(topo, rt)
    dest = np.broadcast_to(np.arange(n)[None, :], (n, n))
    pos = np.broadcast_to(np.arange(n)[:, None], (n, n)).copy()
    active = (np.asarray(rt.next_link) >= 0) & (pos != dest)
    if exclude_pairs is not None and len(exclude_pairs):
        ex = np.asarray(exclude_pairs).reshape(-1, 2)
        uni = ex[ex[:, 1] < n]  # tree route ids have no (chip, dest) cell
        active[uni[:, 0], uni[:, 1]] = False
    prev_q = np.full((n, n), -1, np.int64)
    parts = []
    for _ in range(max(n - 1, 0)):
        if not active.any():
            break
        q = np.where(active, step_q[pos, dest], -1)
        dep = active & (prev_q >= 0) & (q >= 0)
        if dep.any():
            parts.append(np.stack([prev_q[dep], q[dep]], 1))
        prev_q = np.where(active, q, prev_q)
        nxt = step_to[pos, dest]
        pos = np.where(active & (nxt >= 0), nxt, pos)
        active = active & (pos != dest)
    for tree in trees:
        par = np.asarray(tree.parent)
        ed = np.asarray(tree.edges).reshape(-1, 4)
        nz = par >= 0
        if nz.any():
            child_q = ed[nz, 1] * 2 + ed[nz, 2]
            parent_q = ed[par[nz], 1] * 2 + ed[par[nz], 2]
            parts.append(np.stack([parent_q, child_q], 1).astype(np.int64))
    if parts:
        edges = np.unique(np.concatenate(parts, 0), axis=0)
    else:
        edges = np.zeros((0, 2), np.int64)
    return ChannelGraph(topo, edges.astype(np.int32))


# -----------------------------------------------------------------------
# Report structure
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class Finding:
    """One verifier observation.  ``severity`` is ``"error"`` (the
    config is refused — ``VerifyReport.ok`` is False), ``"warning"``
    (admitted, but a hazard the caller should know about) or ``"info"``
    (context)."""
    severity: str
    check: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.check}: {self.message}"


@dataclass(frozen=True)
class VerifyReport:
    """Everything ``Fabric.verify(spec)`` can prove without running.

    ``ok``               — no error-severity findings: the config is
                           admitted.
    ``deadlock_free``    — True when a static certificate exists (see
                           ``certificate``); False means "not proven",
                           which is an error only if the hazard is
                           saturable under the spec.
    ``certificate``      — why deadlock cannot happen: ``"acyclic-cdg"``
                           (Dally–Seitz), ``"capacity-slack"`` (every
                           CDG cycle crosses a channel whose worst-case
                           insertions stay below capacity),
                           ``"drop-mode"`` (no backpressure gating) —
                           or ``""`` when unproven.
    ``findings``         — graded observations, errors first.
    ``cdg_nodes/edges``  — CDG size (channels with any dependency).
    ``cdg_cycle``        — one named channel cycle of the full CDG
                           (``None`` when acyclic).
    ``route_cycles``     — (chip, route) pairs whose walk never reaches
                           delivery (route >= n_chips = multicast tree).
    ``clock_bound_ns``   — worst-case end time under the tight per-link
                           budget (``None`` without a spec).
    ``clock_headroom_ns``— ``BIG_NS - clock_bound_ns`` (negative =
                           refused; ``None`` without a spec).
    ``n_trees``          — multicast trees covered by the analysis.
    """
    ok: bool
    deadlock_free: bool
    certificate: str
    findings: tuple[Finding, ...]
    cdg_nodes: int
    cdg_edges: int
    cdg_cycle: tuple[str, ...] | None
    route_cycles: np.ndarray = field(repr=False)
    clock_bound_ns: int | None
    clock_headroom_ns: int | None
    n_trees: int

    @property
    def errors(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    def raise_if_failed(self) -> "VerifyReport":
        """Raise ``ValueError`` listing every error finding (the CI
        precision gate's refusal path); return self when ok."""
        if not self.ok:
            raise ValueError(
                "fabric pre-flight verification failed:\n"
                + "\n".join(str(f) for f in self.errors))
        return self

    def summary(self) -> str:
        head = ("OK" if self.ok else "REFUSED") + (
            f" deadlock_free={self.deadlock_free}"
            f" certificate={self.certificate or 'none'!r}"
            f" cdg={self.cdg_nodes}ch/{self.cdg_edges}dep")
        if self.clock_headroom_ns is not None:
            head += f" clock_headroom={self.clock_headroom_ns}ns"
        lines = [head] + [str(f) for f in self.findings]
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.summary()


# -----------------------------------------------------------------------
# The verifier
# -----------------------------------------------------------------------

def _spec_routes(fab, spec, findings: list[Finding]):
    """Expand ``spec`` to unicast (src, dest) streams + multicast trees
    exactly the way planning does, downgrading hard errors to findings
    so the report can carry several at once."""
    src = _np(spec.src).astype(np.int32).reshape(-1)
    t = _np(spec.t).astype(np.int32).reshape(-1)
    dest = _np(spec.dest).astype(np.int32).reshape(-1)
    trees: list = []
    tree_counts = np.zeros(0, np.int64)
    if fab.mcast_policy.mode == "in_fabric" and fab.addr is not None:
        is_mc = np.asarray(fab.addr.is_multicast(dest))
        chip_or_tag, _ = fab.addr.unpack(dest)
        u_src, u_dest = src[~is_mc], chip_or_tag[~is_mc]
        m_src, m_tag = src[is_mc], chip_or_tag[is_mc]
        if len(m_src):
            if fab.mcast_policy.table is None:
                findings.append(Finding(
                    "error", "multicast-table",
                    "traffic carries multicast tags but the fabric "
                    "declares no MulticastTable"))
            else:
                pairs = np.unique(np.stack([m_src, m_tag], 1), axis=0)
                counts = []
                for s, g in pairs:
                    try:
                        trees.append(fab._tree(int(s), int(g)))
                        counts.append(int(np.sum((m_src == s)
                                                 & (m_tag == g))))
                    except ValueError as err:
                        findings.append(Finding(
                            "error", "multicast-members", str(err)))
                tree_counts = np.asarray(counts, np.int64)
    else:
        try:
            u_src, t, u_dest = _expand(spec, fab.addr, fab.mcast)
        except ValueError as err:
            findings.append(Finding("error", "multicast-table", str(err)))
            u_src = u_dest = np.zeros(0, np.int32)
    return u_src, u_dest, t, trees, tree_counts


def verify_fabric(fab, spec=None, *, max_steps: int | None = None
                  ) -> VerifyReport:
    """Statically verify a ``Fabric`` (and optionally one traffic spec).

    See the module docstring for the criteria; ``Fabric.verify``
    delegates here.  Without a spec only the structural checks run
    (route termination, CDG, replication completeness) and cyclic-CDG
    hazards cannot be graded by demand, so they surface as warnings for
    the stall modes.  With a spec the report adds reachability, used-
    route termination, drop-mode prefill overflow, the tight clock
    budget, and the saturability grading that turns an engaged deadlock
    hazard into an error.
    """
    topo, rt = fab.topo, fab.routing_table
    n, L = topo.n_chips, topo.n_links
    flow = fab.queues.flow
    cap = fab.queues.capacity
    findings: list[Finding] = []

    u_src = u_dest = None
    trees: list = []
    tree_counts = np.zeros(0, np.int64)
    t_arr = np.zeros(0, np.int32)
    if spec is not None:
        u_src, u_dest, t_arr, trees, tree_counts = _spec_routes(
            fab, spec, findings)

    # ---- route termination (shared traversal, trees included) ---------
    bad = find_route_cycles(topo, rt, trees)
    nonterm = np.zeros((n, n), bool)
    if len(bad):
        uni = bad[bad[:, 1] < n]
        nonterm[uni[:, 0], uni[:, 1]] = True
        shown = ", ".join(f"{c}->{r}" for c, r in bad[:4].tolist())
        # tree routes (route id >= n_chips) exist only because the spec
        # rides them — a cycle there is engaged, not latent
        if np.any(bad[:, 1] >= n):
            sev = "error"
        else:
            sev = "warning" if flow != "drop" else "info"
        findings.append(Finding(
            sev, "route-termination",
            f"{len(bad)} (chip, route) pair(s) never reach delivery "
            f"(next-hop cycle or dead-end), e.g. {shown}; traffic "
            f"addressing them is refused at plan time under "
            f"flow={flow!r} and truncates at the step bound in drop "
            f"mode"))

    # ---- replication-table completeness -------------------------------
    for i, tree in enumerate(trees):
        r = n + i
        ed = np.asarray(tree.edges).reshape(-1, 4)
        par = np.asarray(tree.parent).reshape(-1)
        deliver = np.asarray(tree.deliver, bool)
        sub = np.asarray(tree.subtree, np.int64).reshape(-1)
        if not len(ed):
            continue
        v = ed[:, 3]
        dup = np.flatnonzero(np.bincount(v, minlength=n) > 1)
        if len(dup):
            findings.append(Finding(
                "error", "replication-in-edges",
                f"tree route {r}: chip(s) {dup.tolist()} have more than "
                f"one in-edge — events would be delivered/replicated "
                f"more than once"))
        if np.any(v == tree.src):
            findings.append(Finding(
                "error", "replication-in-edges",
                f"tree route {r}: an edge delivers back into the "
                f"source chip {tree.src}"))
        root_ok = np.all(ed[par < 0, 0] == tree.src)
        chain_ok = np.all(ed[par[par >= 0], 3] == ed[par >= 0, 0])
        if not (root_ok and chain_ok):
            findings.append(Finding(
                "error", "replication-parents",
                f"tree route {r}: parent pointers are inconsistent "
                f"(an edge's source chip is not its parent edge's "
                f"target)"))
        # subtree weights must sum: own delivery + children's subtrees
        want = deliver[v].astype(np.int64)
        np.add.at(want, par[par >= 0], sub[par >= 0])
        if not np.array_equal(want, sub):
            off = np.flatnonzero(want != sub)[:4]
            findings.append(Finding(
                "error", "replication-weights",
                f"tree route {r}: subtree drop-weights do not sum "
                f"(edge(s) {off.tolist()}: stored "
                f"{sub[off].tolist()}, recomputed {want[off].tolist()})"
                f" — drop accounting would break "
                f"delivered + drops == injected"))
        if bool(deliver[tree.src]):
            findings.append(Finding(
                "error", "replication-deliver",
                f"tree route {r}: the source chip {tree.src} is marked "
                f"for delivery (sources never receive their own copy)"))

    # ---- spec checks ---------------------------------------------------
    clock_bound = clock_headroom = None
    demand = None
    if spec is not None and u_src is not None:
        if np.any(u_src == u_dest):
            ex = np.flatnonzero(u_src == u_dest)[:4]
            findings.append(Finding(
                "error", "self-addressed",
                f"event(s) {ex.tolist()} have src == dest"))
        ok_pairs = u_src != u_dest
        first = rt.next_link[u_src, u_dest]
        unreach = ok_pairs & (first < 0)
        if np.any(unreach):
            ex = np.flatnonzero(unreach)[:4]
            findings.append(Finding(
                "error", "reachability",
                f"unreachable destinations, e.g. events {ex.tolist()}: "
                f"src={u_src[unreach][:4].tolist()} "
                f"dest={u_dest[unreach][:4].tolist()}"))
        used_bad = ok_pairs & ~unreach & nonterm[u_src, u_dest]
        if np.any(used_bad):
            pairs = np.unique(np.stack([u_src[used_bad],
                                        u_dest[used_bad]], 1), axis=0)
            shown = ", ".join(f"{c}->{d}" for c, d in pairs[:4].tolist())
            findings.append(Finding(
                "error", "route-termination",
                f"traffic addresses non-terminating route pair(s) "
                f"{shown}: those events are never delivered "
                f"({'the stall chain deadlocks' if flow != 'drop' else 'the run truncates at the step bound'})"))

        # worst-case insertions per flat endpoint queue: prefill +
        # forwards (occupancy can never exceed total insertions, so
        # demand < capacity certifies "this queue can never be full")
        walkable = ok_pairs & ~unreach & ~nonterm[u_src, u_dest]
        demand = np.zeros(2 * L, np.int64)
        if np.any(walkable):
            ws, wd = u_src[walkable], u_dest[walkable]
            np.add.at(demand, _first_hop_queues(rt, ws, wd), 1)
            step_to, step_q = route_step_tables(topo, rt)
            c = ws.astype(np.int64)
            c = step_to[c, wd].astype(np.int64)
            live = c != wd
            for _ in range(max(n - 1, 0)):
                if not live.any():
                    break
                q = step_q[c, wd]
                np.add.at(demand, q[live], 1)
                c = np.where(live, step_to[c, wd], c)
                live = live & (c != wd)
        for tree, cnt in zip(trees, tree_counts):
            ed = np.asarray(tree.edges).reshape(-1, 4)
            if len(ed):
                np.add.at(demand, ed[:, 1] * 2 + ed[:, 2], int(cnt))

        # drop-mode prefill overflow: the logical budget binds the
        # initial backlog too (the stall modes legitimately buffer
        # above capacity at the source)
        if flow == "drop" and cap is not None and np.any(walkable):
            backlog = np.bincount(
                _first_hop_queues(rt, u_src[walkable], u_dest[walkable]),
                minlength=2 * L)
            for tree, cnt in zip(trees, tree_counts):
                ed = np.asarray(tree.edges).reshape(-1, 4)
                roots = ed[np.asarray(tree.parent) < 0]
                if len(roots):
                    np.add.at(backlog, roots[:, 1] * 2 + roots[:, 2],
                              int(cnt))
            worst = int(backlog.max(initial=0))
            if worst > int(cap):
                findings.append(Finding(
                    "error", "prefill-overflow",
                    f"queue capacity {cap} < initial backlog {worst}; "
                    f"raise queue_capacity"))

        # tight int32 clock budget vs the BIG_NS sentinel
        tc, tv, ti = fab.timing_arrays
        link_cost = tc.astype(np.int64) + np.maximum(tv, ti)
        link_tx, walk_ok = _route_link_tx(
            rt, topo.links, u_src[walkable], u_dest[walkable], L, n)
        for tree, cnt in zip(trees, tree_counts):
            ed = np.asarray(tree.edges).reshape(-1, 4)
            if len(ed):
                np.add.at(link_tx, ed[:, 1], int(cnt))
        t_max = int(np.asarray(t_arr).max(initial=0))
        clock_bound = _clock_bound(t_max, link_tx, link_cost)
        clock_headroom = int(_BIG) - clock_bound
        if clock_headroom <= 0:
            findings.append(Finding(
                "error", "clock-overflow",
                f"worst-case end time {clock_bound} ns reaches the "
                f"BIG_NS sentinel ({int(_BIG)} ns); rebase injection "
                f"times or split the simulation"))

    # ---- channel-dependency graph (Dally–Seitz) ------------------------
    g = cdg = channel_graph(topo, rt, trees, exclude_pairs=bad)
    cycle = g.find_cycle()
    cycle_names = tuple(describe_channel(topo, q)
                        for q in cycle) if cycle else None
    deadlock_free = False
    certificate = ""
    if flow == "drop":
        deadlock_free = True
        certificate = "drop-mode"
        if cycle is not None:
            findings.append(Finding(
                "info", "cdg-cycle",
                f"channel-dependency cycle {g.describe_cycle(cycle)} — "
                f"harmless in drop mode (overflowing forwards drop, "
                f"pops are never gated), but this route set would be a "
                f"deadlock hazard under flow='credit'/'onoff'"))
    elif cycle is None:
        deadlock_free = True
        certificate = "acyclic-cdg"
    else:
        sat_cycle = None
        if demand is not None and cap is not None:
            saturable = demand >= int(cap)
            sat_cycle = g.restrict(saturable).find_cycle()
            if sat_cycle is None:
                deadlock_free = True
                certificate = "capacity-slack"
                findings.append(Finding(
                    "info", "cdg-cycle",
                    f"channel-dependency cycle "
                    f"{g.describe_cycle(cycle)} cannot engage: every "
                    f"such cycle crosses a channel whose worst-case "
                    f"insertions stay below capacity {cap} (a queue "
                    f"that is never full never gates its upstream "
                    f"pop)"))
            else:
                findings.append(Finding(
                    "error", "cdg-cycle",
                    f"deadlock hazard: channel-dependency cycle "
                    f"{g.describe_cycle(sat_cycle)} with every channel "
                    f"saturable (worst-case insertions >= capacity "
                    f"{cap}) under flow={flow!r} — the stall chain can "
                    f"lock up; re-route, raise capacity, or use "
                    f"flow='drop'"))
        else:
            findings.append(Finding(
                "warning", "cdg-cycle",
                f"channel-dependency cycle {g.describe_cycle(cycle)} "
                f"under flow={flow!r}: deadlock possible if every "
                f"channel on a cycle can fill to capacity — pass a "
                f"traffic spec to verify() to grade the hazard by "
                f"static demand"))

    if max_steps is not None and spec is not None and u_src is not None:
        # the plan's own default bound is safe whenever routes
        # terminate; a smaller explicit bound may truncate
        hops = rt.hops[u_src, u_dest]
        total_tx = int(hops[hops > 0].sum()) + int(
            sum(tr.n_edges * int(c) for tr, c in zip(trees, tree_counts)))
        default = 4 * total_tx + 2 * max(len(u_src), 1) \
            + 64 * (rt.diameter + 2)
        if int(max_steps) < default:
            findings.append(Finding(
                "warning", "step-bound",
                f"max_steps={max_steps} is below the safe default "
                f"bound {default}; a binding bound truncates delivery"))

    order = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: order.get(f.severity, 3))
    used = np.zeros(2 * L, bool)
    if len(cdg.edges):
        used[cdg.edges[:, 0]] = True
        used[cdg.edges[:, 1]] = True
    return VerifyReport(
        ok=not any(f.severity == "error" for f in findings),
        deadlock_free=deadlock_free,
        certificate=certificate,
        findings=tuple(findings),
        cdg_nodes=int(used.sum()),
        cdg_edges=cdg.n_edges,
        cdg_cycle=cycle_names,
        route_cycles=bad,
        clock_bound_ns=clock_bound,
        clock_headroom_ns=clock_headroom,
        n_trees=len(trees))
