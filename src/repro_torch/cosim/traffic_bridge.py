"""Spike-driven traffic as a first-class generator for sweeps.

The PyTorch counterpart of the reference ``cosim/traffic_bridge.py``: it
rolls a LIF network out open-loop on a ring and returns the resulting
inter-chip Address-Event stream as an ordinary ``TrafficSpec`` (int32
CPU tensors, bare chip-id destinations), with the port's generator
signature ``(gen, n_chips, events_per_chip)`` (``core/traffic.py``), so
any plain ``Fabric`` consumes it unchanged.

SNN traffic is tick-phased (bursts at membrane-update boundaries),
spatially structured by the projection graph and rate-modulated by the
network's own dynamics, which no Poisson or bursty generator
reproduces.  The rollout runs on ``device`` (``None``: the CUDA card);
``weights`` / ``drive`` carry another package's network across (see
``CosimEngine``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.router import ring_topology
from ..core.traffic import TrafficSpec
from .engine import CosimConfig, CosimEngine
from .placement import LANES, Population, Projection, place

__all__ = ["spike_traffic", "snn_feedforward", "snn_recurrent",
           "SNN_PATTERNS"]

#: tick period of the bridge rollouts (ns) — 10 kHz network update
TICK_DT_NS = 10_000


def _ring_placement(n_chips: int, mode: str, addr=None):
    """One population per chip on a ring; projections by ``mode``:
    ``"feedforward"`` chains i -> i+1, ``"recurrent"`` adds the reverse
    chain and local self-recurrence.  Every cross route is unicast, so
    the default ``addr=None`` yields bare chip-id destinations; pass an
    ``AddressSpec`` to get packed words instead."""
    pops = [Population(f"pop{i}", LANES) for i in range(n_chips)]
    projs = []
    for i in range(n_chips):
        projs.append(Projection(pre=i, posts=((i + 1) % n_chips,),
                                w_scale=0.4))
    if mode == "recurrent":
        for i in range(n_chips):
            projs.append(Projection(pre=i,
                                    posts=((i - 1) % n_chips,),
                                    w_scale=0.4))
            projs.append(Projection(pre=i, posts=(i,), w_scale=0.3))
    elif mode != "feedforward":
        raise ValueError(f"unknown bridge mode {mode!r}")
    return place(pops, projs, ring_topology(n_chips), addr=addr)


def spike_traffic(gen: torch.Generator, n_chips: int, events_per_chip: int,
                  *, mode: str = "feedforward", input_rate: float = 0.06,
                  max_ticks: int = 256, device=None, weights=None,
                  drive=None) -> TrafficSpec:
    """Sample ``>= n_chips * events_per_chip`` inter-chip spike events
    from an open-loop LIF rollout on a ring of ``n_chips`` chips, then
    truncate to exactly that count (a whole prefix, so per-source time
    order survives).  Deterministic in ``gen``'s seed.  Raises if
    ``max_ticks`` ticks cannot supply the budget."""
    target = n_chips * events_per_chip
    pl = _ring_placement(n_chips, mode)
    eng = CosimEngine(pl, CosimConfig(input_rate=input_rate,
                                      tick_dt_ns=TICK_DT_NS,
                                      feedback="none"),
                      generator=gen, device=device, weights=weights)
    res = eng.run(max_ticks, collect_events=True, drive=drive)
    total = int(sum(e.n_events for e in res.events))
    if total < target:
        raise ValueError(
            f"snn traffic underran: {total} events in {max_ticks} ticks "
            f"< {target} requested (raise input_rate or max_ticks)")
    src = np.concatenate([e.spec.src.numpy() for e in res.events])
    t = np.concatenate([e.spec.t.numpy() for e in res.events])
    dest = np.concatenate([e.spec.dest.numpy() for e in res.events])
    return TrafficSpec(src=torch.from_numpy(src[:target]),
                       t=torch.from_numpy(t[:target]),
                       dest=torch.from_numpy(dest[:target]))


def snn_feedforward(gen, n_chips: int, events_per_chip: int, *,
                    device=None) -> TrafficSpec:
    return spike_traffic(gen, n_chips, events_per_chip,
                         mode="feedforward", device=device)


def snn_recurrent(gen, n_chips: int, events_per_chip: int, *,
                  device=None) -> TrafficSpec:
    return spike_traffic(gen, n_chips, events_per_chip, mode="recurrent",
                         device=device)


#: name -> generator(gen, n_chips, events_per_chip): the spike-driven
#: counterpart of ``traffic.PATTERNS`` (kept separate so importing the
#: cosim layer never mutates the synthetic registry).
SNN_PATTERNS = {
    "snn_feedforward": snn_feedforward,
    "snn_recurrent": snn_recurrent,
}
