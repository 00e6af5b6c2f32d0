"""Declarative fabric front door: composable policies + compile/run lifecycle.

The PyTorch counterpart of the reference ``core/fabric.py``.  A
:class:`Fabric` is topology plus four policies — ``routing``
(:class:`StaticShortestPath`, a prebuilt ``RoutingTable``, or
:class:`repro_torch.core.adaptive.AdaptiveRouting`, which splits each
``run`` into epochs and re-weights the tables from per-link telemetry
between them), ``timing`` (scalar or per-link ``LinkTiming``),
``queues`` (:class:`QueuePolicy`) and ``engine`` (:class:`EngineSpec`)
— and a device:

    fab = Fabric(ring_topology(8), queues=QueuePolicy(max_burst=1))
    report = fab.verify(spec)       # static pre-flight, runs nothing
    cf = fab.compile(spec)          # bind one shape bucket, warm it
    res = cf.run(spec)
    results = fab.run_many(specs)   # one batched run where they share a bucket
    batch = fab.run_batch(specs)    # B instances, one computation
    cells = fab.sweep(specs)        # timed runs, warm-up kept out

``device=None`` means the CUDA card and raises without one; the tests
pass ``device="cpu"``.  PyTorch runs eagerly, so "compile" binds the
bucket (the reference's shape signature, kept identical) and warms its
runner: the ring engine and the per-step kernel engine capture their
CUDA graph, the kernel engines build their CUDA kernels; nothing is
traced.  Runners are shared by bucket across fabrics
(``network.engine_runner``): ``CompiledFabric.cache_size`` counts them,
and a fabric that differs only in its tables (an adaptive run's
per-epoch clone) reuses the graph.  On the card every engine but
``engine="reference"`` runs from CUDA graphs or the multi-step kernel
(``CompiledFabric.graph``).

Ported: everything the reference's module does — the ring engine (the
default, ``"auto"``), the slot engines (``"reference"``, ``"pallas"``
with ``kernel="step"`` and ``kernel="multistep"``), unicast and both
multicast modes, every flow mode with the static verifier's quarantine
of broken route pairs, adaptive routing and epoched runs, timed sweeps,
and batches of B instances on every engine (:func:`run_batch`) — on one
device; sharding a batch over several cards is not
(:func:`run_batch`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device
from .link import PAPER_TIMING, LinkTiming, link_timing_arrays
from .network import (DEFAULT_CHUNK_SIZE, ENGINES, FabricBatchResult,
                      FabricResult, _BIG, _RING_D_FLOOR, _RING_E_FLOOR,
                      _RING_K_FLOOR, _RING_L_FLOOR, _RING_N_FLOOR,
                      _RING_R_FLOOR, _RING_STREAM_FLOOR, _check_reachable,
                      _expand, _first_hop_queues, _in_edge_ranks,
                      _overflow_guard, _overflow_guard_routed, _pad_to,
                      _pow2ceil, _prefill, _route_link_tx,
                      _routes_with_trees, _stream_quota,
                      _tree_stream_quota, _unicast_routes, engine_runner,
                      runner_count)
from .router import (AddressSpec, MulticastTable, MulticastTree,
                     RoutingTable, Topology, find_route_cycles)
from .telemetry import Telemetry, _np
from .traffic import TrafficSpec

__all__ = ["Fabric", "CompiledFabric", "QueuePolicy", "FLOW_MODES",
           "EngineSpec", "MulticastPolicy", "RoutingPolicy",
           "StaticShortestPath", "PrebuiltRouting", "SweepCell",
           "BatchSweepCell", "run_batch", "batch_cache_size"]

#: flow-control modes, in engine encoding order
FLOW_MODES = ("drop", "credit", "onoff")


@dataclass(frozen=True)
class QueuePolicy:
    """Per-endpoint queue behaviour (see the reference): ``capacity``
    (None = lossless), ``max_burst`` (0 = paper-faithful grant rule),
    ``initial_tx`` (scalar or (L,)), ``flow`` (``"drop"`` /
    ``"credit"`` / ``"onoff"``) and ``xon`` (on/off resume threshold,
    default ``capacity // 2``)."""
    capacity: int | None = None
    max_burst: int = 0
    initial_tx: int | np.ndarray = 1
    flow: str = "drop"
    xon: int | None = None

    def __post_init__(self):
        if self.capacity is not None and int(self.capacity) < 1:
            raise ValueError(f"queue capacity must be >= 1, got "
                             f"{self.capacity}")
        if int(self.max_burst) < 0:
            raise ValueError(f"max_burst must be >= 0, got {self.max_burst}")
        if self.flow not in FLOW_MODES:
            raise ValueError(f"unknown flow mode {self.flow!r}; expected "
                             f"one of {FLOW_MODES}")
        if self.flow != "drop" and self.capacity is None:
            raise ValueError(f"flow={self.flow!r} needs a finite queue "
                             f"capacity (capacity=None is already "
                             f"lossless)")
        if self.xon is not None:
            if self.flow != "onoff":
                raise ValueError("xon only applies to flow='onoff'")
            if not 0 <= int(self.xon) < int(self.capacity):
                raise ValueError(f"xon must satisfy 0 <= xon < capacity, "
                                 f"got xon={self.xon} with "
                                 f"capacity={self.capacity}")


@dataclass(frozen=True)
class EngineSpec:
    """Which bit-exact event-transport engine runs the simulation.

    ``name`` — ``"auto"`` (= ``"ring"``, as in the reference),
    ``"ring"``, ``"reference"`` or ``"pallas"`` (see ``network``'s
    module docstring).  ``"pallas"`` is the slot engine whose per-step
    queue scan and pop/append scatter are the hand-written Hopper
    kernels of ``kernels/fabric_queue.py`` (the name is kept for parity
    with the reference package, where it is the Pallas TPU engine; on
    the CPU the same wrappers run their plain versions);
    ``"reference"`` the same step over the plain-PyTorch versions on
    any device.

    ``chunk_size`` — ring engine: micro-transactions between early-exit
    checks (on the card, replays of a ``network.RING_GRAPH_STEPS``-step
    CUDA graph).  Multi-step kernel: micro-transactions per launch.

    ``kernel`` — pallas engine only.  ``"step"`` (default): two kernel
    launches per micro-transaction, replayed on the card from a CUDA
    graph of ``network.GRAPH_STEPS`` steps captured once per bucket and
    kept across runs (runs too short for ``network.GRAPH_MIN_REPLAYS``
    replays stay eager).
    ``"multistep"``: the whole step in one kernel, ``chunk_size`` steps
    per launch, so a run costs ``ceil(max_steps / chunk_size)``
    launches — the fastest path on the card.  It needs ``name="pallas"``
    given explicitly (``"auto"`` resolves to the ring engine).
    """
    name: str = "auto"
    chunk_size: int = DEFAULT_CHUNK_SIZE
    kernel: str = "step"

    KERNELS = ("step", "multistep")

    def __post_init__(self):
        if self.resolved not in ENGINES:
            raise ValueError(f"unknown engine {self.name!r}; expected one "
                             f"of {ENGINES} (or 'auto')")
        if int(self.chunk_size) < 1:
            # a 0-step chunk would make the early-exit loop spin forever
            raise ValueError(f"chunk_size must be >= 1, got "
                             f"{self.chunk_size}")
        if self.kernel not in self.KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; expected "
                             f"one of {self.KERNELS}")
        if self.kernel == "multistep" and self.resolved != "pallas":
            raise ValueError(
                f"kernel='multistep' is a pallas-engine knob (the fused "
                f"multi-step fabric kernel); engine {self.name!r} "
                f"resolves to {self.resolved!r}")

    @property
    def resolved(self) -> str:
        return "ring" if self.name == "auto" else self.name


@dataclass(frozen=True)
class MulticastPolicy:
    """How tagged events traverse the fabric: ``"source_expand"`` (a tag
    of fanout F becomes F unicast copies at the source) or
    ``"in_fabric"`` (replicated where the per-(source, tag) Steiner tree
    branches).  ``table`` resolves tags to member chips."""
    mode: str = "source_expand"
    table: MulticastTable | None = None

    MODES = ("source_expand", "in_fabric")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"unknown multicast mode {self.mode!r}; "
                             f"expected one of {self.MODES}")
        if self.table is not None and not isinstance(self.table,
                                                     MulticastTable):
            raise TypeError(f"table must be a MulticastTable, got "
                            f"{type(self.table).__name__}")


@runtime_checkable
class RoutingPolicy(Protocol):
    """Anything that turns a topology into next-hop tables."""

    def build(self, topo: Topology) -> RoutingTable: ...


def _validate_tables(topo: Topology, rt: RoutingTable) -> RoutingTable:
    n = topo.n_chips
    for name in ("next_link", "out_side", "hops"):
        a = np.asarray(getattr(rt, name))
        if a.shape != (n, n):
            raise ValueError(f"routing table {name} has shape {a.shape}, "
                             f"expected ({n}, {n})")
    if np.asarray(rt.next_link).max(initial=-1) >= topo.n_links:
        raise ValueError("routing table names a link id outside the "
                         "topology")
    return rt


@dataclass(frozen=True)
class StaticShortestPath:
    """Deterministic BFS shortest-path routing, with an optional
    ``table_override(topo, built_table)`` hook."""
    table_override: Callable[[Topology, RoutingTable],
                             RoutingTable] | None = None

    def build(self, topo: Topology) -> RoutingTable:
        rt = RoutingTable.build(topo)
        if self.table_override is not None:
            rt = _validate_tables(topo, self.table_override(topo, rt))
        return rt


@dataclass(frozen=True)
class PrebuiltRouting:
    """Adapter: a ready-made ``RoutingTable`` as a ``RoutingPolicy``."""
    table: RoutingTable

    def build(self, topo: Topology) -> RoutingTable:
        return _validate_tables(topo, self.table)


class _Plan(NamedTuple):
    """Everything one execution needs (host numpy): routed, prefilled
    queues, replication tables, the flow-control scalars and the shape
    bucket.  ``E`` counts expected deliveries, ``offered`` the events
    before fanout, ``C`` the physical slot width."""
    E: int
    C: int
    max_steps: int
    q_time: np.ndarray
    q_dest: np.ndarray
    q_inj: np.ndarray
    sizes: np.ndarray
    route_out: np.ndarray   # (N, R, K), -1 = none
    route_del: np.ndarray   # (N, R)
    route_wt: np.ndarray    # (N, R, K)
    offered: int
    bucket: tuple
    cap: int = 1
    fc: int = 0
    xon: int = 0


class SweepCell(NamedTuple):
    result: FabricResult
    us_per_call: float
    bucket: tuple


class BatchSweepCell(NamedTuple):
    """Timing of one batched run: ``us_per_call`` the whole batch's
    wall-clock, ``us_per_instance`` its share per fabric (the number to
    set beside a sequential ``sweep``'s ``us_per_call``)."""
    result: FabricBatchResult
    us_per_call: float
    us_per_instance: float
    bucket: tuple


def _sync(device: torch.device) -> None:
    """Wait for ``device`` (the card; the CPU has nothing to wait for)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Fabric:
    """A declarative N-chip AER fabric: topology + policies + device."""

    def __init__(self, topo: Topology, *,
                 routing: RoutingPolicy | RoutingTable | None = None,
                 timing: LinkTiming = PAPER_TIMING,
                 queues: QueuePolicy | None = None,
                 engine: EngineSpec | str | None = None,
                 addr: AddressSpec | None = None,
                 mcast: MulticastTable | MulticastPolicy | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.topo = topo
        if routing is None:
            policy: RoutingPolicy = StaticShortestPath()
        elif isinstance(routing, RoutingTable):
            policy = PrebuiltRouting(routing)
        elif isinstance(routing, RoutingPolicy):
            policy = routing
        else:
            raise TypeError(f"routing must be a RoutingPolicy or a "
                            f"RoutingTable, got {type(routing).__name__}")
        self.routing_policy = policy
        self.queues = queues if queues is not None else QueuePolicy()
        if engine is None:
            engine = EngineSpec()
        elif isinstance(engine, str):
            engine = EngineSpec(name=engine)
        self.engine = engine
        self.timing = timing
        self.addr = addr
        if mcast is None:
            self.mcast_policy = MulticastPolicy()
        elif isinstance(mcast, MulticastPolicy):
            self.mcast_policy = mcast
        elif isinstance(mcast, MulticastTable):
            self.mcast_policy = MulticastPolicy(table=mcast)
        else:
            raise TypeError(f"mcast must be a MulticastTable or a "
                            f"MulticastPolicy, got {type(mcast).__name__}")
        self.mcast = self.mcast_policy.table

        L = topo.n_links
        self.timing_arrays = link_timing_arrays(timing, L)
        tc, tv, ti = self.timing_arrays
        # per-link worst single-transmission cost (routed clock guard)
        # and its fabric-wide max (fallback when routes cannot be walked)
        self._link_cost = tc.astype(np.int64) + np.maximum(tv, ti)
        self._worst_cost = int(self._link_cost.max(initial=1))
        self.routing_table = policy.build(topo)
        # Lossless flow control needs every route to make progress.  A
        # table with broken (chip, dest) pairs (only an override or a
        # prebuilt table can have them) is admitted when the channel-
        # dependency graph of the routes that do terminate is acyclic
        # (the Dally–Seitz criterion, ``analysis.verify``): the broken
        # pairs are QUARANTINED — planning refuses traffic that
        # addresses them (``_plan_impl``) — and everything else provably
        # drains.  A cycle in that graph refuses the table, naming the
        # cycle.  Drop mode admits any table (pops are never gated).
        self._nonterm_mask: np.ndarray | None = None
        if self.queues.flow != "drop":
            bad = find_route_cycles(topo, self.routing_table)
            if len(bad):
                from ..analysis.verify import channel_graph
                g = channel_graph(topo, self.routing_table,
                                  exclude_pairs=bad)
                cycle = g.find_cycle()
                shown = ", ".join(f"{c}->{d}" for c, d in bad[:4].tolist())
                if cycle is not None:
                    raise ValueError(
                        f"routing table has {len(bad)} (chip, dest) "
                        f"pair(s) whose route never reaches the "
                        f"destination (next-hop cycle or dead-end), "
                        f"e.g. {shown}, and the terminating routes' "
                        f"channel-dependency graph also carries a "
                        f"cycle ({g.describe_cycle(cycle)}); "
                        f"flow={self.queues.flow!r} would deadlock — "
                        f"fix the table or use flow='drop'")
                mask = np.zeros((topo.n_chips, topo.n_chips), bool)
                mask[bad[:, 0], bad[:, 1]] = True
                self._nonterm_mask = mask
        self._in_rank, self._D = _in_edge_ranks(topo)
        self._init_tx = np.broadcast_to(
            np.asarray(self.queues.initial_tx, np.int32), (L,))
        self._compiled: dict[tuple, CompiledFabric] = {}
        self._plan_memo: tuple | None = None  # (spec, max_steps, plan)
        #: per-epoch breakdown of the last epoched run (AdaptiveReport)
        self.last_report = None
        #: execution path the last ``run_many`` chose: "batch" | "loop"
        self.last_dispatch = None
        self._tree_cache: dict[tuple[int, int], MulticastTree] = {}
        self._unicast_tables_np: tuple | None = None

    @property
    def n_chips(self) -> int:
        return self.topo.n_chips

    @property
    def n_links(self) -> int:
        return self.topo.n_links

    @property
    def compiled_buckets(self) -> tuple[tuple, ...]:
        """Shape buckets this fabric has bound so far."""
        return tuple(self._compiled)

    def __repr__(self) -> str:
        return (f"Fabric({self.topo.name}: {self.n_chips} chips, "
                f"{self.n_links} links, engine={self.engine.resolved!r}, "
                f"device={self.device})")

    # --- lifecycle ------------------------------------------------------

    def verify(self, spec: TrafficSpec | None = None, *,
               max_steps: int | None = None):
        """Static pre-flight verification — prove properties, run
        nothing: the channel-dependency graph of this fabric's routes
        (unicast and in-fabric multicast branchings) checked for cycles
        (Dally–Seitz), route termination, reachability and replication
        tables checked, and the worst-case int32 clock bounded against
        ``BIG_NS``; with ``spec`` a cycle is graded by whether every
        channel on it can fill to capacity under that traffic.  Returns
        a :class:`repro_torch.analysis.verify.VerifyReport`
        (``raise_if_failed()`` turns its errors into ``ValueError``)."""
        from ..analysis.verify import verify_fabric
        return verify_fabric(self, spec, max_steps=max_steps)

    def compile(self, spec: TrafficSpec, *, max_steps: int | None = None,
                warm: bool = True) -> "CompiledFabric":
        """Bind the shape bucket ``spec`` needs; with ``warm`` also warm
        its runner (kernels built, CUDA graph captured)."""
        plan = self._plan(spec, max_steps)
        cf = self._get_compiled(plan.bucket)
        if warm:
            cf.warmup()
        return cf

    def run(self, spec: TrafficSpec, *,
            max_steps: int | None = None) -> FabricResult:
        """Simulate one traffic spec.  Under an
        :class:`~repro_torch.core.adaptive.AdaptiveRouting` policy the
        run is split into the policy's epochs, telemetry re-weights the
        tables between them, and the merged result comes back (the
        per-epoch breakdown on ``self.last_report``)."""
        from .adaptive import AdaptiveRouting, run_epoched
        if isinstance(self.routing_policy, AdaptiveRouting):
            return run_epoched(self, spec,
                               epochs=self.routing_policy.epochs,
                               max_steps=max_steps,
                               policy=self.routing_policy)
        return self._run_single(spec, max_steps=max_steps)

    def run_epochs(self, spec: TrafficSpec, *, epochs: int,
                   max_steps: int | None = None) -> FabricResult:
        """Epoch-partitioned run under this fabric's own policy: with a
        static policy every epoch reuses the same tables (the A/B
        baseline for adaptive runs: the same partition, drain and
        merge); with an adaptive one ``epochs`` overrides the policy's.
        The per-epoch breakdown lands on ``self.last_report``."""
        from .adaptive import AdaptiveRouting, run_epoched
        pol = (self.routing_policy
               if isinstance(self.routing_policy, AdaptiveRouting)
               else None)
        return run_epoched(self, spec, epochs=epochs,
                           max_steps=max_steps, policy=pol)

    def _run_single(self, spec: TrafficSpec, *,
                    max_steps: int | None = None) -> FabricResult:
        """One run without epochs (the epoch loop's inner call)."""
        plan = self._plan(spec, max_steps)
        return self._get_compiled(plan.bucket)._execute(plan)

    def _with_routing(self, table: RoutingTable) -> "Fabric":
        """A clone with prebuilt routing tables on the same device — the
        adaptive loop's per-epoch rebuild.  In-fabric multicast trees
        regrow on ``table`` (the clone's tree cache starts empty); the
        clone's plans land in this fabric's buckets and run on their
        shared runners (``network.engine_runner``), so it builds and
        captures nothing this fabric already has."""
        return Fabric(self.topo, routing=PrebuiltRouting(table),
                      timing=self.timing, queues=self.queues,
                      engine=self.engine, addr=self.addr,
                      mcast=self.mcast_policy, device=self.device)

    def run_many(self, specs, *,
                 max_steps: int | None = None) -> list[FabricResult]:
        """Run a sequence of specs.  When there are several, the routing
        policy is static and they all land in ONE shape bucket, they run
        as one batch (:meth:`run_batch`, ``last_dispatch == "batch"``);
        otherwise — an adaptive policy is a sequential feedback loop —
        one after another (``"loop"``).  With ``max_steps=None`` a batch
        shares the largest of the specs' default step bounds, which is
        bit-exact with the solo runs wherever they drain."""
        from .adaptive import AdaptiveRouting
        specs = list(specs)
        if (len(specs) > 1
                and not isinstance(self.routing_policy, AdaptiveRouting)):
            plans = [self._plan(s, max_steps) for s in specs]
            if len(dict.fromkeys(p.bucket for p in plans)) == 1:
                self.last_dispatch = "batch"
                return self.run_batch(specs,
                                      max_steps=max_steps).results()
        self.last_dispatch = "loop"
        return [self.run(s, max_steps=max_steps) for s in specs]

    def run_batch(self, specs, *, max_steps: int | None = None,
                  devices: int | str | None = None) -> FabricBatchResult:
        """Run B traffic specs on this fabric as ONE batched computation
        (see the module-level :func:`run_batch`, which also batches
        across fabrics).  Adaptive policies are refused."""
        return run_batch(self, specs, max_steps=max_steps, devices=devices)

    def sweep_batch(self, specs, *, max_steps: int | None = None,
                    warm: bool = True,
                    devices: int | str | None = None) -> BatchSweepCell:
        """:meth:`run_batch` with wall-clock: with ``warm`` the batch's
        runner is first warmed on zero-event instances of the same count
        (kernels built, CUDA graph captured), then the one batched run is
        timed to its end on the device.  ``us_per_instance`` is the
        share per fabric."""
        specs = list(specs)
        fabs = [self] * len(specs)
        plans = _plan_batch(fabs, specs, max_steps)
        _resolve_devices(devices, len(plans))
        cfs = [self._get_compiled(plans[0].bucket)] * len(plans)
        if warm:
            zero = _zero_event_plan(self, plans[0].bucket)
            runner, ops = _runner_and_operands(cfs, [zero] * len(plans))
            runner.warm(ops)
        _sync(self.device)
        t0 = time.perf_counter()
        res = _execute_batch(cfs, plans)
        _sync(self.device)
        us = (time.perf_counter() - t0) * 1e6
        return BatchSweepCell(result=res, us_per_call=us,
                              us_per_instance=us / max(len(plans), 1),
                              bucket=plans[0].bucket)

    def sweep(self, specs, *, max_steps: int | None = None,
              warm: bool = True) -> list[SweepCell]:
        """Runs with per-cell wall-clock: warms every distinct bucket
        first (unless ``warm=False``), then times each run to its end on
        the device — the benchmark-sweep pattern, where no kernel build
        or graph capture may fall in a timed cell.  Under an adaptive
        policy each cell is a whole epoched run, and each spec's first
        epoch slice is warmed under the step bound the epoched run will
        use (the slot engines key their bucket on it)."""
        from .adaptive import (AdaptiveRouting, partition_epochs,
                               shared_max_steps)
        if isinstance(self.routing_policy, AdaptiveRouting):
            bounds = {}
            if warm:
                for i, s in enumerate(specs):
                    parts = partition_epochs(
                        s, self.routing_policy.epochs)
                    if parts:
                        bounds[i] = (max_steps if max_steps is not None
                                     else shared_max_steps(
                                         self, parts,
                                         detour_factor=1.0 + float(
                                             self.routing_policy.alpha)))
                        self.compile(parts[0], max_steps=bounds[i])
            cells = []
            for i, s in enumerate(specs):
                _sync(self.device)
                t0 = time.perf_counter()
                # the warm pass's bound, so the run provably hits the
                # warmed bucket (the merge reads the results on the host)
                res = self.run(s, max_steps=bounds.get(i, max_steps))
                _sync(self.device)
                us = (time.perf_counter() - t0) * 1e6
                cells.append(SweepCell(
                    result=res, us_per_call=us,
                    bucket=self.last_report.buckets[0]))
            return cells
        plans = [self._plan(s, max_steps) for s in specs]
        if warm:
            for b in dict.fromkeys(p.bucket for p in plans):
                self._get_compiled(b).warmup()
        cells = []
        for p in plans:
            _sync(self.device)
            t0 = time.perf_counter()
            res = self._get_compiled(p.bucket)._execute(p)
            _sync(self.device)
            us = (time.perf_counter() - t0) * 1e6
            cells.append(SweepCell(result=res, us_per_call=us,
                                   bucket=p.bucket))
        return cells

    # --- internals ------------------------------------------------------

    def _get_compiled(self, bucket: tuple) -> "CompiledFabric":
        cf = self._compiled.get(bucket)
        if cf is None:
            cf = CompiledFabric(self, bucket)
            self._compiled[bucket] = cf
        return cf

    def _plan(self, spec: TrafficSpec, max_steps: int | None) -> _Plan:
        # memoize the last plan by spec identity, so compile(spec) ->
        # run(spec) pays the setup-time numpy once
        memo = self._plan_memo
        if memo is not None and memo[0] is spec and memo[1] == max_steps:
            return memo[2]
        plan = self._plan_impl(spec, max_steps)
        self._plan_memo = (spec, max_steps, plan)
        return plan

    def _unicast_tables(self):
        if self._unicast_tables_np is None:
            self._unicast_tables_np = _unicast_routes(self.topo,
                                                      self.routing_table)
        return self._unicast_tables_np

    def _tree(self, src: int, tag: int) -> MulticastTree:
        tree = self._tree_cache.get((src, tag))
        if tree is None:
            tree = MulticastTree.build(self.topo, self.routing_table, src,
                                       self.mcast_policy.table.expand(tag))
            self._tree_cache[(src, tag)] = tree
        return tree

    def _route_in_fabric(self, spec: TrafficSpec):
        """Setup for ``MulticastPolicy("in_fabric")``: split unicast from
        tagged events, build one replication tree per unique (source,
        tag) pair, and emit one prefill copy per source out-edge of the
        tree, in original event order."""
        topo, rt = self.topo, self.routing_table
        N = topo.n_chips
        src = _np(spec.src).astype(np.int32)
        t = _np(spec.t).astype(np.int32)
        dest = _np(spec.dest).astype(np.int32)
        if self.addr is not None:
            is_mc = np.asarray(self.addr.is_multicast(dest))
            chip_or_tag, _ = self.addr.unpack(dest)
        else:
            is_mc = np.zeros(len(dest), bool)
            chip_or_tag = dest
        u_src, u_dest = src[~is_mc], chip_or_tag[~is_mc]
        if np.any(u_src == u_dest):
            raise ValueError("self-addressed events (src == dest)")
        _check_reachable(rt, u_src, u_dest)
        m_src, m_tag = src[is_mc], chip_or_tag[is_mc]
        if len(m_src) and self.mcast_policy.table is None:
            raise ValueError("multicast events but no MulticastTable")

        route_ev = chip_or_tag.astype(np.int64)
        n_copies = np.ones(len(src), np.int64)
        fanout_ev = np.ones(len(src), np.int64)
        if len(m_src):
            pairs, inv = np.unique(np.stack([m_src, m_tag], 1), axis=0,
                                   return_inverse=True)
            inv = inv.reshape(-1)
            trees = [self._tree(int(s), int(g)) for s, g in pairs]
            tree_counts = np.bincount(inv, minlength=len(trees))
            root_qs = [(e[:, 1] * 2 + e[:, 2]).astype(np.int64)
                       for e in (tr.edges[tr.parent < 0] for tr in trees)]
            route_ev[is_mc] = N + inv
            n_copies[is_mc] = np.array([len(q) for q in root_qs],
                                       np.int64)[inv]
            fanout_ev[is_mc] = np.array([tr.fanout for tr in trees],
                                        np.int64)[inv]
        else:
            trees, tree_counts, root_qs, inv = [], np.zeros(0, np.int64), \
                [], np.zeros(0, np.int64)

        ev_idx = np.repeat(np.arange(len(src)), n_copies)
        is_mc_copy = is_mc[ev_idx]
        grp = np.empty(len(ev_idx), np.int64)
        grp[~is_mc_copy] = _first_hop_queues(rt, u_src, u_dest)
        if len(m_src):
            grp[is_mc_copy] = np.concatenate([root_qs[j] for j in inv])
        expected = int(fanout_ev.sum())
        total_tx = int(rt.hops[u_src, u_dest].sum()) + int(
            sum(tr.n_edges * int(c) for tr, c in zip(trees, tree_counts)))
        return (grp, t[ev_idx], route_ev[ev_idx].astype(np.int32),
                t[ev_idx], u_src, u_dest, trees, tree_counts,
                expected, total_tx)

    def _plan_impl(self, spec: TrafficSpec, max_steps: int | None) -> _Plan:
        topo, rt = self.topo, self.routing_table
        L = topo.n_links
        if self.mcast_policy.mode == "in_fabric":
            (grp, copy_t, copy_route, copy_inj, u_src, u_dest, trees,
             tree_counts, E, total_tx) = self._route_in_fabric(spec)
            route_out, route_del, route_wt = _routes_with_trees(
                topo, rt, trees)
        else:
            src, t, dest = _expand(spec, self.addr, self.mcast)
            if np.any(src == dest):
                raise ValueError("self-addressed events (src == dest)")
            _check_reachable(rt, src, dest)
            route_out, route_del, route_wt = self._unicast_tables()
            grp = _first_hop_queues(rt, src, dest)
            copy_t = copy_inj = t
            copy_route = dest
            u_src, u_dest, trees, tree_counts = src, dest, [], []
            E = len(src)
            total_tx = int(rt.hops[src, dest].sum())
        if L == 0 or E == 0:
            raise ValueError("need at least one link and one event")
        # quarantined route pairs (admitted at construction because the
        # remaining channel-dependency graph is acyclic): lossless flow
        # refuses traffic that would ride them — it can never be
        # delivered, and its stall chain would wedge the run
        if self._nonterm_mask is not None:
            hit = self._nonterm_mask[u_src, u_dest]
            if np.any(hit):
                pairs = np.unique(np.stack([u_src[hit], u_dest[hit]], 1),
                                  axis=0)
                shown = ", ".join(f"{c}->{d}"
                                  for c, d in pairs[:4].tolist())
                raise ValueError(
                    f"traffic addresses quarantined route pair(s) "
                    f"{shown} whose walk never reaches the destination "
                    f"(next-hop cycle or dead-end); "
                    f"flow={self.queues.flow!r} would deadlock on them "
                    f"— re-route those events or use flow='drop'")

        cap_opt = self.queues.capacity
        cap = int(cap_opt) if cap_opt is not None else max(E, 1)
        fc = FLOW_MODES.index(self.queues.flow)
        xon = (int(self.queues.xon) if self.queues.xon is not None
               else (cap // 2 if fc == 2 else 0))
        # drop mode: the logical budget binds the initial backlog too;
        # the lossless modes only need the physical width
        chk = cap if fc == 0 else max(E, 1)
        # physical slot width: the expanded event count, so the capacity
        # stays out of the shape bucket
        C = max(E, 1)
        if max_steps is None:
            max_steps = 4 * total_tx + 2 * E + 64 * (rt.diameter + 2)
        t_max = int(copy_t.max(initial=0))
        link_tx, walk_ok = _route_link_tx(rt, topo.links, u_src, u_dest,
                                          L, topo.n_chips)
        if walk_ok:
            for tr, cnt in zip(trees, tree_counts):
                if tr.n_edges:
                    np.add.at(link_tx, tr.edges[:, 1], int(cnt))
            _overflow_guard_routed(t_max, link_tx, self._link_cost)
        else:
            _overflow_guard(t_max, total_tx, self._worst_cost)
        R, K = route_out.shape[1], route_out.shape[2]

        eng = self.engine.resolved
        if eng == "ring":
            quota = _stream_quota(rt, topo.links, self._in_rank, u_src,
                                  u_dest, L, self._D)
            if trees:
                quota = quota + _tree_stream_quota(trees, tree_counts,
                                                   self._in_rank, L,
                                                   self._D)
            qt, qd, qi, sizes = _prefill(L, grp, copy_t, copy_route,
                                         copy_inj, chk, width="auto")
            # the reference's bucket, field for field: pow2-padded shapes
            # (+1 = an always-BIG_NS pad column a stream head never
            # passes); a fabric without a multicast table keeps K = 1
            k_floor = (_RING_K_FLOOR if self.mcast_policy.table is not None
                       else 1)
            Cf = _pow2ceil(max(int(quota.max(initial=1)),
                               _RING_STREAM_FLOOR)) + 1
            bucket = ("ring",
                      _pow2ceil(max(L, _RING_L_FLOOR)),
                      _pow2ceil(max(topo.n_chips, _RING_N_FLOOR)),
                      _pow2ceil(max(E, _RING_E_FLOOR)),
                      qt.shape[2],
                      _pow2ceil(max(self._D, _RING_D_FLOOR)),
                      Cf,
                      _pow2ceil(max(R, _RING_R_FLOOR)),
                      _pow2ceil(max(K, k_floor)),
                      int(self.engine.chunk_size))
        else:
            qt, qd, qi, sizes = _prefill(L, grp, copy_t, copy_route,
                                         copy_inj, chk, width=C)
            # the reference's slot-engine bucket, verbatim: chunk keys
            # only the multi-step kernel (it is 0 under "step")
            kern = self.engine.kernel
            chunk = int(self.engine.chunk_size) if kern == "multistep" \
                else 0
            bucket = (eng, L, E, C, int(max_steps),
                      int(self.queues.max_burst), R, K, kern, chunk)
        return _Plan(E=E, C=C, max_steps=int(max_steps), q_time=qt,
                     q_dest=qd, q_inj=qi, sizes=sizes,
                     route_out=route_out, route_del=route_del,
                     route_wt=route_wt, offered=spec.n_events,
                     bucket=bucket, cap=cap, fc=fc, xon=xon)


def _dev_i32(a, device: torch.device) -> torch.Tensor:
    """A fresh int32 device copy of a host array (never a view of it:
    the engine updates its queue planes in place)."""
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _stacked(arrays, device: torch.device) -> torch.Tensor:
    """B host arrays of one shape as one (B, ...) int32 device tensor
    (one copy to the device)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.stack([np.asarray(a, np.int32) for a in arrays]))).to(device)


class CompiledFabric:
    """A :class:`Fabric` bound to ONE engine shape bucket — the
    reference's tuple, field for field: ``("ring", Lp, Np, Ep, C0, Dp,
    Cf, Rp, Kp, chunk)`` (pow2-padded) for the ring engine, ``(engine,
    L, E, C, max_steps, max_burst, R, K, kernel, chunk)`` for the slot
    engines.  Its runs go to the bucket's runners, which every fabric on
    the device shares (``network.engine_runner``); ``cache_size()``
    counts them, and a hot path can assert it stays flat."""

    def __init__(self, fabric: Fabric, bucket: tuple):
        self.fabric = fabric
        self.bucket = bucket
        self.n_runs = 0
        topo = fabric.topo
        tc, tv, ti = fabric.timing_arrays
        if bucket[0] == "ring":
            Lp = bucket[1]
            # bucket-padded link tables (dummy links park forever: empty
            # queues, zero-cost timing); the replication tables carry the
            # spec's multicast trees and are padded per plan
            self._tables = (
                _pad_to(np.asarray(fabric._init_tx, np.int32), (Lp,), 1),
                _pad_to(np.asarray(topo.links, np.int32), (Lp, 2), 0),
                _pad_to(np.asarray(fabric._in_rank, np.int32), (Lp, 2), 0),
                *(_pad_to(np.asarray(a, np.int32), (Lp,), 0)
                  for a in (tc, tv, ti)))
        else:
            self._tables = tuple(np.asarray(a, np.int32) for a in (
                fabric._init_tx, topo.links, tc, tv, ti))
        #: the shared runner this bucket's last run went to
        self._last_runner = None
        self._warmed = False

    @property
    def engine_name(self) -> str:
        return self.bucket[0]

    def __repr__(self) -> str:
        return f"CompiledFabric(bucket={self.bucket}, runs={self.n_runs})"

    def cache_size(self) -> int:
        """Runners (bound step programs) the process holds for this
        bucket on this fabric's device, one for each flow mode and burst
        bound it has run with: the counterpart of the reference's jit
        entries.  Runs of one shape — other traffic, other tables, any
        number of fabrics — leave it at 1."""
        return runner_count(self.bucket, self.fabric.device, batched=False)

    @property
    def graph(self) -> dict | None:
        """How the last run (or ``warmup``) of this bucket's runner went;
        the runner is shared by every fabric of the bucket, so this is
        its last run whichever fabric made it.  Per-step kernel engine:
        ``graph_steps``, its eager ``head`` and ``tail`` steps, its
        ``replays``, whether that run ``captured`` the graph (then
        ``capture_s``, ``instantiate_s``), the host seconds spent
        issuing the replays (``replay_host_s``) and the first of them
        (``first_replay_host_s``).  Ring engine: ``chunk``, the
        ``steps`` it ran, its ``chunks`` and graph ``replays``, its
        ``host_syncs`` (early-exit flag reads), whether it ``captured``
        (with ``capture_s``, ``instantiate_s``) and the host seconds
        from its first replay to its last one's end, flag reads included
        (``replay_host_s``).  Both: how many graphs the runner has
        captured (``captures``; one for any number of runs and fabrics)
        and the card's seconds from the first replay's start to the last
        one's end (``replay_device_s``, read from CUDA events; this
        waits for the replays to finish).  None for the other engines
        and before a run."""
        runner = self._last_runner
        if runner is None or runner.stats is None:
            return None
        stats = dict(runner.stats, captures=runner.captures)
        if "replay_events" in stats:
            start, end = stats.pop("replay_events")
            end.synchronize()
            stats["replay_device_s"] = start.elapsed_time(end) / 1e3
        return stats

    def run(self, spec: TrafficSpec, *,
            max_steps: int | None = None) -> FabricResult:
        """Run one spec, refusing specs that fall outside this bucket."""
        plan = self.fabric._plan(spec, max_steps)
        if plan.bucket != self.bucket:
            raise ValueError(
                f"spec needs shape bucket {plan.bucket} but this "
                f"CompiledFabric is bound to {self.bucket}; use "
                f"Fabric.run (auto-routes) or Fabric.compile the new "
                f"bucket")
        return self._execute(plan)

    def warmup(self) -> "CompiledFabric":
        """Make this bucket ready (the counterpart of the reference's
        pre-compilation): its solo runner warms on a zero-event plan —
        the ring engine runs step 0 and, on the card, captures its
        chunk's CUDA graph; the per-step kernel engine builds its kernels,
        runs steps 0 and 1 and captures its graph where the bucket's
        plan replays one; the multi-step engine builds its kernel.  A
        runner that another fabric already warmed captures nothing
        again.  Idempotent."""
        if self._warmed:
            return self
        runner, ops = _runner_and_operands(
            [self], [_zero_event_plan(self.fabric, self.bucket)])
        runner.warm(ops)
        self._last_runner = runner
        self._warmed = True
        return self

    def _operands(self, plan: _Plan) -> tuple:
        """The slot engine's operands for one plan, without an instance
        axis: fresh device copies of the queue planes, the tables, and
        the plain-int flow-control scalars."""
        dev = self.fabric.device
        L, C = self.fabric.topo.n_links, plan.C
        init_tx, links, tc, tv, ti = (_dev_i32(a, dev) for a in self._tables)
        return (_dev_i32(plan.q_time.reshape(2 * L, C), dev),
                _dev_i32(plan.q_dest.reshape(2 * L, C), dev),
                _dev_i32(plan.q_inj.reshape(2 * L, C), dev),
                _dev_i32(plan.sizes, dev), init_tx, links,
                _dev_i32(plan.route_out, dev), _dev_i32(plan.route_del, dev),
                _dev_i32(plan.route_wt, dev), tc, tv, ti,
                plan.cap, plan.fc, plan.xon)

    def _execute(self, plan: _Plan) -> FabricResult:
        return _execute_batch([self], [plan]).instance(0)


# -----------------------------------------------------------------------
# Batched execution: B fabric instances as ONE computation
# -----------------------------------------------------------------------

def run_batch(fabrics, specs, *, max_steps: int | None = None,
              devices: int | str | None = None) -> FabricBatchResult:
    """Run B (fabric, spec) instances as one batched computation.

    ``fabrics`` is one :class:`Fabric` (replicated across the batch —
    the Monte-Carlo-over-seeds case) or B fabrics on one device sharing
    the link count and, with their specs, one shape bucket; they may
    differ in routing tables, timing, queue policy and reset polarity,
    all run operands.  Every engine runs the batch as one loop over
    steps with the batch in every launch (the ring engine until every
    instance has drained); instance i is bit-exact with
    ``fabrics[i].run(specs[i])``.  With ``max_steps=None`` the
    instances share the largest of their default step bounds, which a
    drained run never reaches.

    ``devices``: ``None`` or 1 (this fabric's device).  Sharding the
    batch over several cards is not ported: its reference test fails
    (ROADMAP queue C), so nothing passing holds it.  Adaptive routing
    policies are refused: their epoch loop is sequential feedback.
    """
    specs = list(specs)
    fabs = ([fabrics] * len(specs) if isinstance(fabrics, Fabric)
            else list(fabrics))
    if len(fabs) != len(specs):
        raise ValueError(f"got {len(fabs)} fabrics for {len(specs)} "
                         f"specs; they must pair 1:1 (or pass a single "
                         f"Fabric to replicate)")
    plans = _plan_batch(fabs, specs, max_steps)
    _resolve_devices(devices, len(plans))
    bucket = plans[0].bucket
    return _execute_batch([f._get_compiled(bucket) for f in fabs], plans)


def _plan_batch(fabs: list[Fabric], specs, max_steps: int | None):
    """Per-instance plans under one shared step bound and ONE bucket
    (the ring bucket ignores the bound; slot plans with another default
    are planned again under the shared one)."""
    if not specs:
        raise ValueError("run_batch needs at least one instance")
    from .adaptive import AdaptiveRouting
    for f in fabs:
        if isinstance(f.routing_policy, AdaptiveRouting):
            raise NotImplementedError(
                "run_batch under AdaptiveRouting is refused: the epoch "
                "loop is sequential feedback (epoch k's telemetry "
                "re-weights epoch k+1's tables), so instances cannot "
                "fuse into one computation. Run adaptive specs through "
                "Fabric.run / run_epochs; batch the static baseline.")
    L, dev = fabs[0].topo.n_links, fabs[0].device
    for f in fabs[1:]:
        if f.topo.n_links != L:
            raise ValueError(f"all fabrics in a batch must share the "
                             f"link count, got {f.topo.n_links} vs {L}")
        if f.device != dev:
            raise ValueError(f"all fabrics in a batch must share one "
                             f"device, got {f.device} vs {dev}")
    plans = [f._plan(s, max_steps) for f, s in zip(fabs, specs)]
    if max_steps is None:
        shared = max(p.max_steps for p in plans)
        plans = [p._replace(max_steps=shared) if p.bucket[0] == "ring"
                 else (p if p.max_steps == shared else f._plan(s, shared))
                 for f, s, p in zip(fabs, specs, plans)]
    buckets = dict.fromkeys(p.bucket for p in plans)
    if len(buckets) != 1:
        raise ValueError(
            f"run_batch needs every instance in ONE shape bucket, got "
            f"{list(buckets)}; Fabric.run_many loops mixed buckets")
    return plans


def _resolve_devices(devices: int | str | None, batch: int) -> int:
    """Devices for the batch axis: one (``None``, 1, or ``"all"`` where
    one card is visible).  More are refused (see :func:`run_batch`)."""
    if devices is None:
        return 1
    n = max(torch.cuda.device_count(), 1) if devices == "all" \
        else int(devices)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {devices!r}")
    if n > 1:
        raise NotImplementedError(
            f"run_batch(devices={devices!r}): sharding a batch of {batch} "
            f"over {n} cards is not ported; its reference test fails "
            f"(ROADMAP queue C), so nothing passing holds it")
    return 1


def _zero_event_plan(fab: Fabric, bucket: tuple) -> _Plan:
    """A plan that offers no traffic (every slot ``BIG_NS``, zero
    events) in ``bucket`` — what ``warmup`` runs.  Its flow mode is the
    fabric's, so the ring runner it warms is the one the fabric's runs
    use."""
    L, N = fab.topo.n_links, fab.topo.n_chips
    if bucket[0] == "ring":
        width = bucket[4]
        R, K = N, 1            # _ring_operands pads to the bucket's
    else:
        width = bucket[3]
        R, K = bucket[6], bucket[7]
    qt = np.full((L, 2, width), int(_BIG), np.int32)
    z = np.zeros((L, 2, width), np.int32)
    return _Plan(E=0, C=width, max_steps=0, q_time=qt, q_dest=z, q_inj=z,
                 sizes=np.zeros((L, 2), np.int32),
                 route_out=np.full((N, R, K), -1, np.int32),
                 route_del=np.zeros((N, R), np.int32),
                 route_wt=np.zeros((N, R, K), np.int32),
                 offered=0, bucket=bucket, cap=width,
                 fc=FLOW_MODES.index(fab.queues.flow), xon=0)


def _shared(vals):
    """A flow-control or burst scalar of B instances: the int they all
    share, else the tuple of them."""
    vals = tuple(int(v) for v in vals)
    return vals[0] if len(set(vals)) == 1 else vals


def _on(v, dev):
    """``_shared``'s value as an engine operand: the int, or a (B,)
    int32 tensor on ``dev``."""
    return v if isinstance(v, int) else torch.tensor(v, dtype=torch.int32,
                                                     device=dev)


def _ring_operands(cfs: list[CompiledFabric], plans: list[_Plan], dev):
    """The ring runner's (B, ...) operands (``network.RING_OPERANDS``)
    for B plans of one bucket, padded to it, and the batch's flow mode
    and burst bound (shared ints or per-instance tuples)."""
    _, Lp, Np, _Ep, C0, _Dp, _Cf, Rp, Kp, _chunk = plans[0].bucket

    def pad(name, shape, fill):
        return _stacked([_pad_to(getattr(p, name), shape, fill)
                         for p in plans], dev)

    def vec(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int32,
                            device=dev)

    tabs = [cf._tables for cf in cfs]
    ops = {"q0_time": pad("q_time", (Lp, 2, C0), int(_BIG)),
           "q0_dest": pad("q_dest", (Lp, 2, C0), 0),
           "q0_inj": pad("q_inj", (Lp, 2, C0), 0),
           "sizes": pad("sizes", (Lp, 2), 0),
           "route_out": pad("route_out", (Np, Rp, Kp), -1),
           "route_del": pad("route_del", (Np, Rp), 0),
           "route_wt": pad("route_wt", (Np, Rp, Kp), 0),
           "cap": vec(p.cap for p in plans), "xon": vec(p.xon for p in plans),
           "real_e": vec(p.E for p in plans)}
    for i, name in enumerate(("init_tx", "links", "in_rank", "t_cycle",
                              "t_rev", "t_idle")):
        ops[name] = _stacked([t[i] for t in tabs], dev)
    fc = _shared(p.fc for p in plans)
    mb = _shared(cf.fabric.queues.max_burst for cf in cfs)
    if not isinstance(fc, int):
        ops["fc_mode"] = _on(fc, dev)
    if not isinstance(mb, int):
        ops["max_burst"] = _on(mb, dev)
    return ops, fc, mb


def _slot_operands(cfs: list[CompiledFabric], plans: list[_Plan], dev):
    """The slot engines' (B, ...) operands for B plans of one bucket,
    with the flow-control scalars as plain ints where the instances
    share them, else (B,) tensors."""
    L, C = cfs[0].fabric.topo.n_links, plans[0].C
    planes = [_stacked([getattr(p, f).reshape(2 * L, C) for p in plans],
                       dev) for f in ("q_time", "q_dest", "q_inj")]
    tabs = [cf._tables for cf in cfs]
    init_tx, links, tc, tv, ti = (_stacked([t[i] for t in tabs], dev)
                                  for i in range(5))
    return (*planes, _stacked([p.sizes for p in plans], dev), init_tx,
            links, *(_stacked([getattr(p, f) for p in plans], dev)
                     for f in ("route_out", "route_del", "route_wt")),
            tc, tv, ti,
            *(_on(_shared(getattr(p, f) for p in plans), dev)
              for f in ("cap", "fc", "xon")))


def _runner_and_operands(cfs: list[CompiledFabric], plans: list[_Plan]):
    """The shared runner that runs ``plans`` (B instances of one bucket)
    on their device, and its operands: the ring runner for this batch
    size, flow modes and burst bounds, or the slot engine's."""
    owner = cfs[0]
    fab, dev = owner.fabric, owner.fabric.device
    if owner.engine_name == "ring":
        ops, fc, mb = _ring_operands(cfs, plans, dev)
    else:
        ops = _slot_operands(cfs, plans, dev)
        fc = _shared(p.fc for p in plans)
        mb = int(owner.bucket[5])
    runner = engine_runner(owner.bucket, dev, len(plans), fc, mb,
                           fab.topo.n_chips)
    return runner, ops


def batch_cache_size(bucket: tuple, n_devices: int = 1, *,
                     device=None) -> int:
    """Runners the process holds for batches of ``bucket`` on ``device``
    (``None``: the CUDA card), across every batch size, flow mode and
    burst bound — the batch path's no-rebuild audit: a repeated batch of
    one size leaves it unchanged.  Batches of one device only."""
    _resolve_devices(n_devices, 1)
    return runner_count(bucket, resolve_device(device), batched=True)


def _execute_batch(cfs: list[CompiledFabric],
                   plans: list[_Plan]) -> FabricBatchResult:
    """Run B plans of one bucket as one computation on the bucket's
    shared runner (the first instance's ``CompiledFabric.graph`` then
    reports the run) and trim the bucket's padding."""
    owner = cfs[0]
    L = owner.fabric.topo.n_links
    runner, ops = _runner_and_operands(cfs, plans)
    if owner.engine_name == "ring":
        out = runner.run(ops, max(p.max_steps for p in plans))
    else:
        out = runner(*ops)
    owner._last_runner = runner
    if owner.engine_name == "ring":
        (log_n, log_inj, log_del, log_dest, sent, n_sw, t_link, drops,
         busy_ns, busy_steps, q_drops, stall_steps, credit_waits) = out
        e_max = max(p.E for p in plans)
        log_inj, log_del, log_dest = (log_inj[:, :e_max],
                                      log_del[:, :e_max],
                                      log_dest[:, :e_max])
        sent, n_sw, t_link = sent[:, :L], n_sw[:, :L], t_link[:, :L]
        busy_ns, busy_steps, q_drops = (busy_ns[:, :L], busy_steps[:, :L],
                                        q_drops[:, :L])
        stall_steps, credit_waits = stall_steps[:, :L], credit_waits[:, :L]
        t_end = t_link.amax(dim=1)
    else:
        (log_n, log_inj, log_del, log_dest, sent, n_sw, t_link, t_end,
         drops, busy_ns, busy_steps, q_drops, stall_steps,
         credit_waits) = out
    owner.n_runs += 1
    owner._warmed = True
    return FabricBatchResult(
        delivered=log_n, injected=np.asarray([p.E for p in plans], np.int64),
        log_inj=log_inj, log_del=log_del, log_dest=log_dest, sent=sent,
        n_switches=n_sw, t_link=t_link, t_end=t_end, drops=drops,
        offered=np.asarray([p.offered for p in plans], np.int64),
        telemetry=Telemetry(busy_ns=busy_ns, busy_steps=busy_steps,
                            q_drops=q_drops, stall_steps=stall_steps,
                            credit_waits=credit_waits))
