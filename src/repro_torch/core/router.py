"""Hierarchical AER addressing + routing for multi-chip transceiver fabrics.

Plain numpy, kept as the port's own copy of the reference package's
``core/router.py`` (importing that package would pull JAX in); the two
must build identical tables, which ``tests/test_torch_router.py`` holds.

The paper validates one bi-directional link; its stated purpose is
large-scale multi-chip systems.  This module supplies the addressing layer
that scales the link into a fabric, following the hierarchy used by
DYNAPs-style boards (Moradi et al. 2017) and the tag-expansion multicast of
Su et al. 2024:

* ``AddressSpec`` — carves the paper's 26-bit parallel AER word into
  ``[mcast flag | chip id | core/neuron tag]`` fields.  Unicast events carry
  an explicit destination chip; multicast events carry a *tag* that each
  expansion point resolves through a ``MulticastTable``.
* ``Topology`` — chips + bi-directional links (each link is one instance of
  the paper's transceiver pair sharing one AER bus).  Builders for line,
  ring and 2-D mesh fabrics.
* ``RoutingTable`` — deterministic BFS shortest-path next-hop tables
  (``next_link`` / ``out_side`` / ``hops``), precomputed in numpy at build
  time so the in-scan forwarding step is a pure table gather.

Everything here is *setup-time* code (plain numpy, no tracing); the hot
per-micro-transaction path lives in ``network.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "AddressSpec", "Topology", "RoutingTable", "MulticastTable",
    "MulticastTree", "find_route_cycles", "route_step_tables",
    "find_tree_cycles", "line_topology", "ring_topology",
    "mesh2d_topology",
]


# -----------------------------------------------------------------------
# Hierarchical addressing over the 26-bit AER word
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class AddressSpec:
    """Bit layout of one AER word: ``[mcast | chip | core]`` (MSB first).

    The paper's bus is ``word_bits`` = 26 wires.  One bit flags multicast;
    ``chip_bits`` name the destination chip (or the multicast tag when the
    flag is set); the rest is the on-chip core/neuron address that the
    fabric transports opaquely.
    """
    word_bits: int = 26
    chip_bits: int = 8

    @property
    def core_bits(self) -> int:
        return self.word_bits - self.chip_bits - 1

    @property
    def max_chips(self) -> int:
        return 1 << self.chip_bits

    @property
    def _mcast_bit(self) -> int:
        return 1 << (self.word_bits - 1)

    def pack(self, chip: np.ndarray, core: np.ndarray = 0) -> np.ndarray:
        chip = np.asarray(chip, np.int64)
        core = np.asarray(core, np.int64)
        if np.any(chip >= self.max_chips) or np.any(chip < 0):
            raise ValueError(f"chip id out of range for {self.chip_bits} bits")
        if np.any(core >= (1 << self.core_bits)) or np.any(core < 0):
            raise ValueError(f"core tag out of range for {self.core_bits} bits")
        return ((chip << self.core_bits) | core).astype(np.int32)

    def pack_multicast(self, tag: np.ndarray, core: np.ndarray = 0):
        return (self.pack(tag, core) | self._mcast_bit).astype(np.int32)

    def is_multicast(self, word: np.ndarray) -> np.ndarray:
        return (np.asarray(word, np.int64) & self._mcast_bit) != 0

    def unpack(self, word: np.ndarray):
        """Return ``(chip_or_tag, core)`` — check ``is_multicast`` first."""
        w = np.asarray(word, np.int64) & ~self._mcast_bit
        return ((w >> self.core_bits).astype(np.int32),
                (w & ((1 << self.core_bits) - 1)).astype(np.int32))


# -----------------------------------------------------------------------
# Topologies
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """``n_chips`` chips joined by bi-directional AER links.

    ``links[l] = (a, b)`` — link ``l`` connects chip ``a`` (the link's L
    side, side 0) to chip ``b`` (the R side, side 1).  Each link is one
    shared parallel bus with a transceiver block on both ends, exactly the
    paper's Fig. 1 pair.
    """
    n_chips: int
    links: np.ndarray  # (L, 2) int32
    name: str = "custom"

    def __post_init__(self):
        links = np.asarray(self.links, np.int32).reshape(-1, 2)
        object.__setattr__(self, "links", links)
        if len(links) and (links.min() < 0 or links.max() >= self.n_chips):
            raise ValueError("link endpoint out of range")
        if np.any(links[:, 0] == links[:, 1]):
            raise ValueError("self-loop link")

    @property
    def n_links(self) -> int:
        return len(self.links)


def line_topology(n_chips: int) -> Topology:
    links = [(i, i + 1) for i in range(n_chips - 1)]
    return Topology(n_chips, np.asarray(links, np.int32), name=f"line{n_chips}")


def ring_topology(n_chips: int) -> Topology:
    """Ring of n chips.  ``n == 2`` degenerates to a single link (the
    paper's measured configuration) rather than a doubled bus."""
    if n_chips < 2:
        raise ValueError("ring needs >= 2 chips")
    if n_chips == 2:
        return Topology(2, np.asarray([(0, 1)], np.int32), name="ring2")
    links = [(i, (i + 1) % n_chips) for i in range(n_chips)]
    return Topology(n_chips, np.asarray(links, np.int32),
                    name=f"ring{n_chips}")


def mesh2d_topology(rows: int, cols: int) -> Topology:
    """2-D mesh (the four-border chip floorplan of the paper's prototype
    scaled out): chip (r, c) has id ``r * cols + c``."""
    links = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                links.append((i, i + 1))
            if r + 1 < rows:
                links.append((i, i + cols))
    return Topology(rows * cols, np.asarray(links, np.int32),
                    name=f"mesh{rows}x{cols}")


# -----------------------------------------------------------------------
# Deterministic shortest-path routing
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class RoutingTable:
    """Next-hop tables: at chip ``c`` an event for chip ``d`` departs on
    link ``next_link[c, d]`` from that link's side ``out_side[c, d]``
    (0 = the link's L endpoint, 1 = R).  ``hops[c, d]`` is the path length.
    Diagonals and unreachable pairs hold -1.
    """
    next_link: np.ndarray  # (N, N) int32
    out_side: np.ndarray   # (N, N) int32
    hops: np.ndarray       # (N, N) int32

    @staticmethod
    def build(topo: Topology) -> "RoutingTable":
        """BFS from every destination, ties broken by lowest (chip, link)
        so the tables are reproducible across runs."""
        n, links = topo.n_chips, topo.links
        # adjacency: chip -> sorted [(neighbor, link, my_side)]
        adj: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
        for l, (a, b) in enumerate(links):
            adj[a].append((b, l, 0))
            adj[b].append((a, l, 1))
        for lst in adj:
            lst.sort()

        next_link = np.full((n, n), -1, np.int32)
        out_side = np.full((n, n), -1, np.int32)
        hops = np.full((n, n), -1, np.int32)
        for dst in range(n):
            hops[dst, dst] = 0
            frontier = [dst]
            while frontier:
                nxt = []
                for u in frontier:
                    for v, l, side_of_u in adj[u]:
                        if hops[v, dst] == -1:
                            hops[v, dst] = hops[u, dst] + 1
                            # v forwards toward dst over link l; v sits on
                            # the opposite side from u.
                            next_link[v, dst] = l
                            out_side[v, dst] = 1 - side_of_u
                            nxt.append(v)
                frontier = sorted(nxt)
        return RoutingTable(next_link=next_link, out_side=out_side, hops=hops)

    @property
    def diameter(self) -> int:
        reach = self.hops[self.hops >= 0]
        return int(reach.max()) if reach.size else 0

    @staticmethod
    def build_weighted(topo: Topology,
                       link_cost: np.ndarray) -> "RoutingTable":
        """Shortest-path tables over positive per-link costs (Dijkstra
        from every destination) — the congestion-weighted generalisation
        of :meth:`build` the adaptive control plane recomputes per epoch.

        ``link_cost`` is an (L,) array of integer costs >= 1 (integer so
        route selection is exactly reproducible across platforms — the
        adaptive policies quantise their congestion weights before
        calling in).  Next hops minimise the total path cost; ties break
        to the lowest (predecessor chip, link) pair, which makes the
        choice deterministic AND makes uniform costs reproduce
        :meth:`build`'s BFS tables bit-exactly (tested) — so a zero
        congestion weight degenerates to static shortest-path routing.

        ``hops`` still counts *links traversed* along the chosen route
        (not cost): the step-bound and stream-quota estimators consume
        path lengths.  Next hops strictly decrease the remaining cost,
        so weighted routes can never cycle.
        """
        import heapq
        cost = np.asarray(link_cost)
        if cost.shape != (topo.n_links,):
            raise ValueError(f"link_cost must have shape "
                             f"({topo.n_links},), got {cost.shape}")
        if cost.size and (np.any(cost < 1)
                          or np.any(cost != np.floor(cost))):
            raise ValueError("link costs must be integers >= 1")
        cost = cost.astype(np.int64)
        n = topo.n_chips
        adj: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
        for l, (a, b) in enumerate(topo.links):
            adj[a].append((b, l, 0))
            adj[b].append((a, l, 1))
        for lst in adj:
            lst.sort()

        next_link = np.full((n, n), -1, np.int32)
        out_side = np.full((n, n), -1, np.int32)
        hops = np.full((n, n), -1, np.int32)
        inf = np.iinfo(np.int64).max
        for dst in range(n):
            dist = np.full(n, inf, np.int64)
            dist[dst] = 0
            heap = [(0, dst)]
            done = np.zeros(n, bool)
            order = []
            while heap:
                d, u = heapq.heappop(heap)
                if done[u]:
                    continue
                done[u] = True
                order.append(u)
                for v, l, _side_u in adj[u]:
                    nd = d + cost[l]
                    if nd < dist[v]:
                        dist[v] = nd
                        heapq.heappush(heap, (nd, v))
            hops[dst, dst] = 0
            # settle next hops in ascending (dist, chip) order: the
            # chosen predecessor always has strictly smaller dist, so
            # its hop count is final when we read it.  adj[v] entries
            # are (neighbor u, link l, v's side of l), sorted — the min
            # below is the deterministic (cost, chip, link) tie-break.
            for v in order[1:]:
                best = min((dist[u] + cost[l], u, l, side_v)
                           for u, l, side_v in adj[v]
                           if dist[u] < inf)
                _, u, l, side_v = best
                next_link[v, dst] = l
                out_side[v, dst] = side_v
                hops[v, dst] = hops[u, dst] + 1
        return RoutingTable(next_link=next_link, out_side=out_side,
                            hops=hops)


def route_step_tables(topo: Topology, rt: RoutingTable):
    """One-step traversal tables of the unicast functional route graph.

    ``step_to[c, d]`` is the chip an event at ``c`` bound for ``d``
    forwards to (the far endpoint of the chosen link) and
    ``step_q[c, d]`` the flat endpoint-queue id it transmits from
    (``link * 2 + out_side`` — the engines' queue encoding); both are
    -1 where no route exists.  This is THE definition of "the route an
    event takes": :func:`find_route_cycles` and the reference package's
    static verifier walk the same tables, so the termination check and
    the channel-dependency graph can never disagree about a path.
    """
    links = topo.links
    nl = np.asarray(rt.next_link)
    os_ = np.asarray(rt.out_side)
    step_to = np.where(nl >= 0,
                       links[np.maximum(nl, 0), 1 - np.maximum(os_, 0)],
                       -1).astype(np.int32)
    step_q = np.where(nl >= 0, nl * 2 + np.maximum(os_, 0),
                      -1).astype(np.int32)
    return step_to, step_q


def find_tree_cycles(topo: Topology, trees) -> np.ndarray:
    """Chips whose in-fabric replication never terminates, per tree.

    A :class:`MulticastTree` route is the multicast analogue of a
    unicast ``next_link`` column: an event arriving at chip ``u`` on
    tree route ``N + i`` replicates along the tree's out-edges of
    ``u``.  Trees built by :meth:`MulticastTree.build` are rooted
    forests by construction, but hand-built trees (or corrupted
    replication tables) can carry an edge cycle — an event riding one
    replicates forever, exactly the failure mode a cyclic unicast
    column has.  For each tree the edge graph ``u -> v`` is reduced to
    a fixpoint of "all of my out-edges terminate"; chips that never
    reach it (they lie on, or feed into, an edge cycle) are reported
    as ``(chip, n_chips + i)`` pairs — the same (chip, route-id)
    coordinates the engines' replication tables use.
    """
    n = topo.n_chips
    bad: list[tuple[int, int]] = []
    for i, tree in enumerate(trees):
        edges = np.asarray(tree.edges, np.int64).reshape(-1, 4)
        if not len(edges):
            continue
        terminated = np.ones(n, bool)
        has_out = np.zeros(n, bool)
        has_out[edges[:, 0]] = True
        terminated[has_out] = False
        for _ in range(n):
            ok = terminated.copy()
            # a chip terminates once every chip it replicates to does
            nxt_ok = np.ones(n, bool)
            np.logical_and.at(nxt_ok, edges[:, 0], terminated[edges[:, 3]])
            ok |= nxt_ok & has_out
            if np.array_equal(ok, terminated):
                break
            terminated = ok
        touched = np.zeros(n, bool)
        touched[edges[:, 0]] = True
        touched[edges[:, 3]] = True
        for c in np.flatnonzero(touched & ~terminated):
            bad.append((int(c), n + i))
    return np.asarray(bad, np.int32).reshape(-1, 2)


def find_route_cycles(topo: Topology, rt: RoutingTable,
                      trees=()) -> np.ndarray:
    """All ``(chip, route)`` pairs whose forwarding walk never reaches
    delivery — i.e. the pairs caught on (or feeding into) a next-hop
    cycle of a hand-built / overridden table.

    For each destination the ``next_link`` column is a functional graph
    on chips; a walk from every chip either reaches the destination
    within ``n_chips - 1`` hops or is provably cyclic.  The walk is
    vectorised over all (chip, dest) pairs at once (numpy, setup-time)
    over the shared :func:`route_step_tables` traversal.  Pairs with no
    route at all (``next_link < 0`` off-diagonal) are *unreachable*,
    not cyclic, and are not reported — ``Fabric`` rejects those
    separately when traffic actually addresses them.

    ``trees`` extends the check to in-fabric multicast replication
    (route id ``n_chips + i`` for ``trees[i]``): chips whose
    replication walk cycles are reported in the same (chip, route)
    coordinates — see :func:`find_tree_cycles`.

    Tables built by :meth:`RoutingTable.build` (BFS) or
    :meth:`RoutingTable.build_weighted` (Dijkstra — next hops strictly
    decrease the remaining cost) are acyclic by construction; this check
    exists for ``table_override`` hooks and prebuilt tables, where a
    cycle would otherwise silently truncate at the step bound (drop
    mode) or deadlock the lossless flow-control modes.  Routes that
    dead-end mid-path (an intermediate chip with no next hop) are
    reported too — the walk never arrives either way.  Returns an
    ``(n_bad, 2)`` int32 array of ``(chip, route)`` pairs.
    """
    n = topo.n_chips
    step_to, _step_q = route_step_tables(topo, rt)
    dest = np.broadcast_to(np.arange(n)[None, :], (n, n))
    pos = np.broadcast_to(np.arange(n)[:, None], (n, n)).copy()
    routed = (np.asarray(rt.next_link) >= 0) & (pos != dest)
    for _ in range(max(n - 1, 0)):
        at_dest = pos == dest
        nxt = step_to[pos, dest]
        # walk only pairs that still have a route and haven't arrived
        pos = np.where(~at_dest & routed & (nxt >= 0), nxt, pos)
    cyclic = routed & (pos != dest)
    out = np.argwhere(cyclic).astype(np.int32)
    if len(trees):
        out = np.concatenate(
            [out.reshape(-1, 2), find_tree_cycles(topo, trees)], 0)
    return out.astype(np.int32)


# -----------------------------------------------------------------------
# Multicast (Su et al.-style tag expansion)
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class MulticastTable:
    """Tag → member-chip sets.  ``members[tag, chip]`` is True when the
    chip subscribes to the tag.  Expansion replicates a tagged event into
    one unicast copy per member (the source never receives its own copy),
    which is how the Su et al. scheme resolves tags at expansion nodes.
    """
    members: np.ndarray  # (n_tags, n_chips) bool

    def __post_init__(self):
        object.__setattr__(self, "members",
                           np.asarray(self.members, bool).reshape(
                               len(self.members), -1))

    @property
    def n_tags(self) -> int:
        return self.members.shape[0]

    def expand(self, tag: int, src: int | None = None) -> np.ndarray:
        """Member chips of ``tag`` (excluding ``src`` when given)."""
        chips = np.flatnonzero(self.members[tag])
        if src is not None:
            chips = chips[chips != src]
        return chips.astype(np.int32)

    def expand_stream(self, src, t, tag):
        """Vector expansion of a tagged event stream into unicast triples.

        Returns ``(src', t', dest')`` where each input event is replicated
        once per member chip of its tag, source excluded.  Fully
        vectorized: one boolean gather + ``np.nonzero`` (row-major, so
        copies appear in event order and, within an event, in ascending
        member-chip order — exactly the order ``expand`` yields).
        """
        src = np.asarray(src, np.int32).reshape(-1)
        t = np.asarray(t, np.int32).reshape(-1)
        tag = np.asarray(tag, np.int32).reshape(-1)
        mask = self.members[tag].copy()          # (E, n_chips)
        if len(src):
            mask[np.arange(len(src)), src] = False   # source never receives
        ev, chips = np.nonzero(mask)
        return (src[ev].astype(np.int32), t[ev].astype(np.int32),
                chips.astype(np.int32))


# -----------------------------------------------------------------------
# In-fabric multicast replication trees
# -----------------------------------------------------------------------

@dataclass(frozen=True)
class MulticastTree:
    """Replication tree of one ``(source, tag)`` pair.

    The Steiner-branching of the per-destination BFS shortest paths:
    member paths are grafted onto the growing tree at their last shared
    node (members processed in ascending chip order, so the tree is
    deterministic), which guarantees every tree node has exactly ONE
    in-edge — an event replicated along the tree reaches each member
    exactly once.  A tagged event traverses each tree edge once instead
    of once per downstream member, which is where in-fabric replication
    saves link occupancy and energy over source expansion.

    ``edges[e] = (u, link, out_side, v)`` — the copy leaves chip ``u`` on
    ``link`` (from the link's ``out_side`` endpoint) toward ``v``.
    ``parent[e]`` is the edge index delivering into ``u`` (-1 for edges
    leaving the source — those become queue prefill, not in-fabric
    forwards).  ``deliver[c]`` marks member chips (source excluded);
    ``subtree[e]`` counts the final deliveries at or below ``v`` — the
    number of deliveries lost if the copy on edge ``e`` is dropped, the
    weight the engines' drop accounting uses to keep
    ``delivered + drops == expected`` exact.
    """
    src: int
    edges: np.ndarray    # (n_edges, 4) int32 [u, link, out_side, v]
    parent: np.ndarray   # (n_edges,) int32, -1 = source out-edge
    deliver: np.ndarray  # (n_chips,) bool
    subtree: np.ndarray  # (n_edges,) int32

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def fanout(self) -> int:
        """Final deliveries per injected event on this tree."""
        return int(self.deliver.sum())

    @property
    def max_out_degree(self) -> int:
        """Largest *in-fabric* replication factor: the max out-degree
        over non-source nodes (the engines' K lane bound).  Source
        out-edges are prefill — one injected copy per root edge, never
        a mid-flight replication — so they do not widen K."""
        non_root = self.edges[self.parent >= 0]
        if not len(non_root):
            return 0
        return int(np.bincount(non_root[:, 0]).max())

    @staticmethod
    def build(topo: Topology, rt: RoutingTable, src: int,
              members: np.ndarray) -> "MulticastTree":
        """Graft each member's shortest path onto the tree at the last
        on-path node already covered (ascending member order)."""
        deliver = np.zeros(topo.n_chips, bool)
        in_edge: dict[int, int] = {int(src): -1}
        edges: list[tuple[int, int, int, int]] = []
        parent: list[int] = []
        for d in sorted(int(m) for m in np.asarray(members).reshape(-1)):
            if d == src:
                continue
            if rt.hops[src, d] < 0:
                raise ValueError(f"multicast member chip {d} unreachable "
                                 f"from source {src}")
            deliver[d] = True
            path = []
            c = int(src)
            while c != d:
                l = int(rt.next_link[c, d])
                s = int(rt.out_side[c, d])
                v = int(topo.links[l][1 - s])
                path.append((c, l, s, v))
                c = v
            nodes = [int(src)] + [st[3] for st in path]
            graft = max(i for i, nd in enumerate(nodes) if nd in in_edge)
            for (u, l, s, v) in path[graft:]:
                parent.append(in_edge[u])
                in_edge[v] = len(edges)
                edges.append((u, l, s, v))
        edges_a = np.asarray(edges, np.int32).reshape(-1, 4)
        parent_a = np.asarray(parent, np.int32).reshape(-1)
        subtree = deliver[edges_a[:, 3]].astype(np.int32) \
            if len(edges) else np.zeros(0, np.int32)
        for e in range(len(edges) - 1, -1, -1):
            if parent_a[e] >= 0:
                subtree[parent_a[e]] += subtree[e]
        return MulticastTree(src=int(src), edges=edges_a, parent=parent_a,
                             deliver=deliver, subtree=subtree)
