"""Traffic generators for the multi-chip AER fabric, on ``torch.Generator``.

The PyTorch counterpart of the reference ``core/traffic.py``.  Each
generator returns a :class:`TrafficSpec` — flat ``(src, t, dest)`` int32
tensors: event ``i`` enters the fabric at chip ``src[i]`` at time
``t[i]`` ns, addressed to chip ``dest[i]``.  Times are nondecreasing per
source chip and a destination is never the source.

PyTorch cannot reproduce JAX's random streams, so these generators keep
the reference's *contract* (shapes, ordering, distributions), not its
bits; parity tests make their traffic with numpy and hand the same
arrays to both packages.  Traffic is setup-time data that the planner
reads on the host, so it is made on the CPU.

Patterns: ``poisson`` (exponential gaps, uniform destinations),
``bursty`` (Poisson burst starts, each a back-to-back train to one
destination), ``ping_pong`` (saturated pairwise exchange at t = 0, the
paper's Fig. 8 on every pair) and ``hot_spot`` (Poisson arrivals
converging on one chip with probability ``hot_frac``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TrafficSpec", "poisson", "bursty", "ping_pong", "hot_spot",
           "monte_carlo", "PATTERNS"]

_I32 = torch.int32


class TrafficSpec(NamedTuple):
    """Flat event stream of int32 tensors."""
    src: torch.Tensor   # (E,)
    t: torch.Tensor     # (E,) nondecreasing per src
    dest: torch.Tensor  # (E,)

    @property
    def n_events(self) -> int:
        return int(self.src.shape[0])


def _flatten(times: torch.Tensor, dests: torch.Tensor) -> TrafficSpec:
    """(n_chips, E) per-chip arrays -> flat spec (chip-major order)."""
    n_chips, n_ev = times.shape
    src = torch.arange(n_chips, dtype=_I32).repeat_interleave(n_ev)
    return TrafficSpec(src=src, t=times.reshape(-1).to(_I32),
                       dest=dests.reshape(-1).to(_I32))


def _src_col(n_chips: int, n_ev: int) -> torch.Tensor:
    return torch.arange(n_chips, dtype=_I32)[:, None].expand(n_chips, n_ev)


def _uniform_other_chip(gen, n_chips: int, src_col: torch.Tensor):
    """Uniform destination chip != source."""
    d = torch.randint(0, n_chips - 1, src_col.shape, generator=gen,
                      dtype=_I32)
    return d + (d >= src_col).to(_I32)


def _arrival_times(gen, n_chips: int, n_ev: int, mean_gap_ns: float):
    gaps = torch.empty((n_chips, n_ev), dtype=torch.float32).exponential_(
        generator=gen) * mean_gap_ns
    return torch.cumsum(gaps.to(_I32), dim=1, dtype=_I32)


def poisson(gen: torch.Generator, n_chips: int, events_per_chip: int,
            mean_gap_ns: float = 200.0) -> TrafficSpec:
    """Independent Poisson processes: exponential gaps, uniform dests."""
    times = _arrival_times(gen, n_chips, events_per_chip, mean_gap_ns)
    dests = _uniform_other_chip(gen, n_chips,
                                _src_col(n_chips, events_per_chip))
    return _flatten(times, dests)


def bursty(gen: torch.Generator, n_chips: int, bursts_per_chip: int,
           burst_len: int = 8, mean_gap_ns: float = 2000.0) -> TrafficSpec:
    """Poisson burst starts; each burst is ``burst_len`` back-to-back
    events (same timestamp — the FIFO serialises them) to one dest."""
    starts = _arrival_times(gen, n_chips, bursts_per_chip, mean_gap_ns)
    burst_dest = _uniform_other_chip(gen, n_chips,
                                     _src_col(n_chips, bursts_per_chip))
    return _flatten(starts.repeat_interleave(burst_len, dim=1),
                    burst_dest.repeat_interleave(burst_len, dim=1))


def ping_pong(n_chips: int, events_per_chip: int) -> TrafficSpec:
    """Saturated pairwise exchange: chips (2i, 2i+1) flood each other
    from t = 0.  An odd trailing chip stays silent (its rows are left
    out)."""
    n_active = (n_chips // 2) * 2
    src = torch.arange(n_active, dtype=_I32)
    partner = torch.where(src % 2 == 0, src + 1, src - 1)
    times = torch.zeros((n_active, events_per_chip), dtype=_I32)
    dests = partner[:, None].expand(n_active, events_per_chip)
    return _flatten(times, dests)


def hot_spot(gen: torch.Generator, n_chips: int, events_per_chip: int,
             mean_gap_ns: float = 200.0, hot_chip: int = 0,
             hot_frac: float = 0.75) -> TrafficSpec:
    """Poisson arrivals converging on ``hot_chip`` with probability
    ``hot_frac`` (uniform otherwise) — the congestion regime."""
    times = _arrival_times(gen, n_chips, events_per_chip, mean_gap_ns)
    col = _src_col(n_chips, events_per_chip)
    uni = _uniform_other_chip(gen, n_chips, col)
    hot = torch.rand(col.shape, generator=gen) < hot_frac
    dests = torch.where(hot & (col != hot_chip), hot_chip, uni)
    return _flatten(times, dests)


def _bursty_default(gen, n_chips, events_per_chip):
    burst_len = 8
    return bursty(gen, n_chips, max(1, events_per_chip // burst_len),
                  burst_len=burst_len)


#: name -> generator(gen, n_chips, events_per_chip) for sweeps/tests.
PATTERNS = {
    "poisson": lambda g, n, e: poisson(g, n, e),
    "bursty": _bursty_default,
    "ping_pong": lambda g, n, e: ping_pong(n, e),
    "hot_spot": lambda g, n, e: hot_spot(g, n, e),
}

#: child seeds are drawn in [0, MC_SEED_BOUND)
MC_SEED_BOUND = 2**62


def monte_carlo(pattern: str, gen: torch.Generator, batch: int,
                n_chips: int, events_per_chip: int) -> list[TrafficSpec]:
    """B independently seeded instances of one traffic scenario.

    The reference splits a JAX key into B subkeys; a ``torch.Generator``
    cannot be split, so the port's contract is: ``batch`` seeds are drawn
    from ``gen`` (``torch.randint(0, MC_SEED_BOUND, (batch,))``, one
    draw), and instance ``i`` is ``PATTERNS[pattern]`` sampled solo from
    a fresh CPU ``torch.Generator`` seeded with the i-th of them.  So an
    instance never depends on the batch size past its own index, and a
    caller can regenerate any one of them alone.  All instances share
    the shape ``(n_chips, events_per_chip)``, so they land in one engine
    shape bucket (``Fabric.run_batch``).  Returns the B specs in seed
    order.
    """
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; expected one of "
                         f"{sorted(PATTERNS)}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    seeds = torch.randint(0, MC_SEED_BOUND, (batch,), generator=gen,
                          dtype=torch.int64).tolist()
    return [PATTERNS[pattern](torch.Generator().manual_seed(s), n_chips,
                              events_per_chip) for s in seeds]
