"""Epoch-based adaptive routing: the fabric's congestion control plane.

The PyTorch counterpart of the reference ``core/adaptive.py`` (see
there for the model).  A run is split into **epochs** — contiguous
injection-time slices of the workload (:func:`partition_epochs`); each
epoch runs on the tables chosen before it started and drains; between
epochs its per-link :class:`~repro_torch.core.telemetry.LinkLoad`
becomes a congestion signal, and the next epoch's tables are rebuilt by
congestion-weighted shortest paths (``RoutingTable.build_weighted``,
integer costs ``base + alpha * load`` quantised by ``_COST_SCALE``),
in-fabric multicast trees regrown on them.

Routing tables are run operands, so every epoch of a run lands in one
shape bucket, and the engine runners are shared by bucket across
fabrics (``network.engine_runner``): the per-epoch clone fabric that
carries the new tables reuses the runner — and on the card the CUDA
graph — that the first epoch bound (``AdaptiveReport.recompiled`` is
False; ``EpochRecord.cache_size`` counts the bucket's runners).

The loop is sequential feedback, so it reads each epoch's
``delivered``, ``drops`` and telemetry on the host once an epoch, and
nowhere inside an epoch's steps.  Batched execution refuses adaptive
policies (``fabric.run_batch``).

Policies (``AdaptiveRouting.policy``): ``"min_backlog"`` (normalised
backlog steps + weighted drops + flow-control stalls per link) and
``"weighted_bfs"`` (link traversals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .network import FabricResult, _expand
from .router import RoutingTable, Topology
from .telemetry import LinkLoad, Telemetry, _np, link_load
from .traffic import TrafficSpec

__all__ = ["AdaptiveRouting", "AdaptiveReport", "EpochRecord",
           "partition_epochs", "merge_results", "run_epoched",
           "shared_max_steps"]

#: Integer quantisation of congestion-weighted edge costs: a base cost
#: of _COST_SCALE per link plus up to ``alpha * _COST_SCALE`` of
#: congestion penalty, rounded; a zero penalty is exactly uniform
#: (BFS-degenerate).
_COST_SCALE = 1024


@dataclass(frozen=True)
class AdaptiveRouting:
    """Congestion-adaptive routing policy (a ``fabric.RoutingPolicy``).

    ``policy`` — ``"min_backlog"`` or ``"weighted_bfs"``.
    ``epochs`` — injection-time slices; tables are recomputed between
    consecutive epochs (``epochs=1`` never adapts).
    ``alpha``  — congestion weight: next-epoch edge cost ``1 + alpha *
    load / max(load)`` (quantised); ``alpha=0`` is static routing.
    ``ema``    — signal smoothing in (0, 1]: ``ema * this_epoch + (1 -
    ema) * previous``.
    ``trigger`` — ``"epoch"`` (rebuild after every epoch) or
    ``"backlog_burst"`` (only when one link's backlog + stall + drop
    integral exceeds ``threshold ×`` the fabric mean).
    """
    policy: str = "min_backlog"
    epochs: int = 4
    alpha: float = 2.0
    ema: float = 0.5
    trigger: str = "epoch"
    threshold: float = 4.0

    POLICIES = ("min_backlog", "weighted_bfs")
    TRIGGERS = ("epoch", "backlog_burst")

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(f"unknown adaptive policy {self.policy!r}; "
                             f"expected one of {self.POLICIES}")
        if int(self.epochs) < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if float(self.alpha) < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if not 0.0 < float(self.ema) <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {self.ema}")
        if self.trigger not in self.TRIGGERS:
            raise ValueError(f"unknown trigger {self.trigger!r}; "
                             f"expected one of {self.TRIGGERS}")
        if float(self.threshold) < 0:
            raise ValueError(f"threshold must be >= 0, got "
                             f"{self.threshold}")

    def build(self, topo: Topology) -> RoutingTable:
        """Epoch 0's tables: the static BFS tables."""
        return RoutingTable.build(topo)

    def load_signal(self, result: FabricResult) -> np.ndarray:
        """(L,) float64 congestion signal from one epoch's telemetry."""
        ll = link_load(result)
        if self.policy == "weighted_bfs":
            return ll.traversals.astype(np.float64)
        parts = [a.astype(np.float64)
                 for a in (ll.backlog_steps, ll.drops, ll.stalls)]
        parts = [a / a.max() if a.max(initial=0) > 0 else a for a in parts]
        return parts[0] + parts[1] + parts[2]

    def should_rebuild(self, load: LinkLoad) -> bool:
        """Does this epoch's telemetry warrant new tables?  Always under
        ``trigger="epoch"``; under ``"backlog_burst"`` only when the
        hottest link's congestion integral exceeds ``threshold ×`` the
        fabric-wide mean."""
        if self.trigger == "epoch":
            return True
        hot = (load.backlog_steps.astype(np.float64)
               + load.stalls.astype(np.float64)
               + load.drops.astype(np.float64))
        mx = float(hot.max(initial=0.0))
        return mx > 0.0 and mx > float(self.threshold) * float(hot.mean())

    def next_table(self, topo: Topology, load: np.ndarray) -> RoutingTable:
        """Congestion-weighted shortest-path tables for the next epoch."""
        load = np.asarray(load, np.float64)
        mx = load.max(initial=0.0)
        if mx <= 0 or float(self.alpha) == 0.0:
            cost = np.full(topo.n_links, _COST_SCALE, np.int64)
        else:
            cost = np.rint(_COST_SCALE
                           * (1.0 + float(self.alpha) * load / mx)
                           ).astype(np.int64)
        return RoutingTable.build_weighted(topo, cost)


class EpochRecord(NamedTuple):
    """One epoch of an epoched run."""
    result: FabricResult        # the epoch's own FabricResult
    table: RoutingTable         # tables the epoch ran on
    load: LinkLoad              # the epoch's telemetry roll-up
    bucket: tuple               # engine shape bucket the epoch used
    cache_size: int             # runners of that bucket on the device
    rebuilt: bool = True        # tables rebuilt AFTER this epoch?


class AdaptiveReport(NamedTuple):
    """Record of one epoched run (``Fabric.last_report``).  ``buckets``
    is the ordered set of shape buckets the epochs used, ``cache_size``
    the runner count of the last epoch's bucket.  The no-rebuild
    contract is :attr:`recompiled` ``== False``: one bucket, and the
    runner count flat from the first epoch on."""
    records: tuple[EpochRecord, ...]
    buckets: tuple[tuple, ...]
    cache_size: int
    result: FabricResult

    @property
    def n_epochs(self) -> int:
        return len(self.records)

    @property
    def recompiled(self) -> bool:
        """True if any epoch after the first bound a new runner."""
        sizes = [r.cache_size for r in self.records]
        return len(self.buckets) != 1 or any(s != sizes[0] for s in sizes)


def partition_epochs(spec: TrafficSpec, epochs: int) -> list[TrafficSpec]:
    """Split a workload into ``epochs`` contiguous injection-time slices:
    events ranked by ``(t, original index)`` and cut at ``i * n //
    epochs``, each slice in original event order; empty slices are
    omitted."""
    if int(epochs) < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    t = _np(spec.t)
    n = len(t)
    order = np.argsort(t, kind="stable")
    parts = []
    for i in range(int(epochs)):
        sel = order[i * n // epochs:(i + 1) * n // epochs]
        if not len(sel):
            continue
        idx = torch.from_numpy(np.sort(sel))
        parts.append(TrafficSpec(src=spec.src[idx], t=spec.t[idx],
                                 dest=spec.dest[idx]))
    return parts


def merge_results(results: list[FabricResult], *,
                  offered: int) -> FabricResult:
    """Fold per-epoch results into one workload-level ``FabricResult``
    on their device, in the reference's dtypes: counters summed
    (``sent``, ``n_switches``, ``drops`` and the telemetry as int64),
    delivery logs concatenated in epoch order (each trimmed to its own
    ``delivered``, int32), clocks the elementwise maximum (int32)."""
    if not results:
        raise ValueError("no epoch results to merge")
    ns = [int(r.delivered) for r in results]
    i64 = torch.int64

    def total(xs):
        return torch.stack([x.to(i64) for x in xs]).sum(dim=0)

    cat = {f: torch.cat([getattr(r, f)[:k] for r, k in zip(results, ns)])
           for f in ("log_inj", "log_del", "log_dest")}
    dev = results[0].sent.device
    return FabricResult(
        delivered=torch.tensor(sum(ns), dtype=torch.int32, device=dev),
        injected=sum(r.injected for r in results),
        log_inj=cat["log_inj"], log_del=cat["log_del"],
        log_dest=cat["log_dest"],
        sent=total([r.sent for r in results]),
        n_switches=total([r.n_switches for r in results]),
        t_link=torch.stack([r.t_link for r in results]).amax(dim=0),
        t_end=torch.stack([r.t_end for r in results]).amax(),
        drops=total([r.drops for r in results]),
        offered=offered,
        telemetry=Telemetry(*(total([getattr(r.telemetry, f)
                                     for r in results])
                              for f in Telemetry._fields)))


def shared_max_steps(fabric, parts: list[TrafficSpec], *,
                     detour_factor: float = 1.0) -> int:
    """One step bound for every epoch, scaled for detour headroom: each
    slice's transmission estimate times ``max(2, detour_factor)``
    (callers pass ``1 + alpha``), capped at ``n_chips - 1`` hops an
    event, in the plan's default formula ``4 * total_tx + 2 * E + 64 *
    (diameter + 2)``; in-fabric multicast slices scale their plan's own
    bound.  One value keeps the slot engines, which key their bucket on
    it, on one bucket across epochs."""
    rt = fabric.routing_table
    f = max(2.0, float(detour_factor))
    N = fabric.topo.n_chips
    ms = 0
    for p in parts:
        if fabric.mcast_policy.mode == "in_fabric":
            ms = max(ms, int(np.ceil(
                f * fabric._plan_impl(p, None).max_steps)))
            continue
        src, _t, dest = _expand(p, fabric.addr, fabric.mcast)
        total_tx = min(int(np.ceil(f * int(rt.hops[src, dest].sum()))),
                       len(src) * max(N - 1, 1))
        ms = max(ms, 4 * total_tx + 2 * len(src)
                 + 64 * (rt.diameter + 2))
    return ms


def run_epoched(fabric, spec: TrafficSpec, *, epochs: int,
                max_steps: int | None = None,
                policy: AdaptiveRouting | None = None) -> FabricResult:
    """Run ``spec`` in injection-time epochs on ``fabric``.

    ``policy=None``: the fabric's own tables serve every epoch (the A/B
    baseline).  With an :class:`AdaptiveRouting` policy each epoch's
    telemetry re-weights the next epoch's tables, run on a clone fabric
    (``Fabric._with_routing``) that shares the bucket's runner.  Returns
    the merged result; the per-epoch breakdown lands on
    ``fabric.last_report``.  An automatic step bound that binds raises.
    """
    parts = partition_epochs(spec, epochs)
    if not parts:
        raise ValueError("workload has no events")
    auto_bound = max_steps is None
    shared_ms = (int(max_steps) if max_steps is not None
                 else shared_max_steps(
                     fabric, parts,
                     detour_factor=1.0 + float(policy.alpha)
                     if policy is not None else 1.0))
    records: list[EpochRecord] = []
    results: list[FabricResult] = []
    epoch_fab = fabric
    table = fabric.routing_table
    signal = None  # EMA-smoothed congestion signal across epochs
    for e, part in enumerate(parts):
        res = epoch_fab._run_single(part, max_steps=shared_ms)
        if auto_bound and \
                int(res.delivered) + int(res.drops) != res.injected:
            raise RuntimeError(
                f"epoch {e} truncated at the auto step bound "
                f"{shared_ms} ({int(res.delivered)} + {int(res.drops)} "
                f"of {res.injected} accounted); pass max_steps "
                f"explicitly to run_epochs/run")
        bucket = epoch_fab._plan(part, shared_ms).bucket
        cf = epoch_fab._get_compiled(bucket)
        load = link_load(res)
        rebuild = (policy is not None and e + 1 < len(parts)
                   and policy.should_rebuild(load))
        records.append(EpochRecord(result=res, table=table, load=load,
                                   bucket=bucket,
                                   cache_size=cf.cache_size(),
                                   rebuilt=rebuild))
        results.append(res)
        if policy is not None and e + 1 < len(parts):
            # the EMA folds every epoch; the rebuild waits for the trigger
            raw = policy.load_signal(res)
            signal = raw if signal is None else (
                float(policy.ema) * raw
                + (1.0 - float(policy.ema)) * signal)
            if rebuild:
                table = policy.next_table(fabric.topo, signal)
                epoch_fab = fabric._with_routing(table)
    merged = merge_results(results, offered=spec.n_events)
    fabric.last_report = AdaptiveReport(
        records=tuple(records),
        buckets=tuple(dict.fromkeys(r.bucket for r in records)),
        cache_size=records[-1].cache_size,
        result=merged)
    return merged
