"""Per-link congestion telemetry: the fabric's measurement plane.

The PyTorch counterpart of the reference ``core/telemetry.py`` (see
there for the exact meaning of each counter).  The slot engine carries
the counters as int32 tensors beside its queues, and they are part of
the engines' bit-exactness contract:

``busy_ns (L,)``         ns each link's clock advanced while transmitting
``busy_steps (L, 2)``    micro-transactions with released backlog
``q_drops (L, 2)``       weighted capacity drops charged to the target queue
``stall_steps (L, 2)``   micro-transactions gated by flow control
``credit_waits (L, 2)``  stall episodes (edges into the stalled state)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Telemetry", "LinkLoad", "link_load", "link_load_batch",
           "merge_telemetry"]


def _np(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Telemetry(NamedTuple):
    busy_ns: torch.Tensor       # (L,)
    busy_steps: torch.Tensor    # (L, 2)
    q_drops: torch.Tensor       # (L, 2)
    stall_steps: torch.Tensor   # (L, 2)
    credit_waits: torch.Tensor  # (L, 2)


def merge_telemetry(parts: list[Telemetry]) -> Telemetry:
    """Sum counters across sub-runs (they are extensive), as int64
    numpy arrays; generic over the fields so none can be dropped."""
    return Telemetry(*(
        sum(_np(getattr(p, f)).astype(np.int64) for p in parts)
        for f in Telemetry._fields))


class LinkLoad(NamedTuple):
    """Per-link load roll-up of one run: transmissions both ways,
    occupancy of the active span, backlog steps, weighted drops and
    flow-control stall steps."""
    traversals: np.ndarray
    occupancy: np.ndarray
    backlog_steps: np.ndarray
    drops: np.ndarray
    stalls: np.ndarray

    def table(self, links: np.ndarray | None = None) -> str:
        """Human-readable per-link table."""
        lines = [f"  {'link':<8}{'trav':>6}{'occ':>7}{'backlog':>9}"
                 f"{'drops':>7}{'stalls':>8}"]
        for l in range(len(self.traversals)):
            name = (f"{l}:{links[l][0]}-{links[l][1]}"
                    if links is not None else str(l))
            lines.append(f"  {name:<8}{int(self.traversals[l]):>6}"
                         f"{100.0 * self.occupancy[l]:>6.0f}%"
                         f"{int(self.backlog_steps[l]):>9}"
                         f"{int(self.drops[l]):>7}"
                         f"{int(self.stalls[l]):>8}")
        return "\n".join(lines)


def link_load(result) -> LinkLoad:
    """Roll one ``FabricResult``'s telemetry up to per-link loads
    (raises when the result carries none)."""
    tel = result.telemetry
    if tel is None:
        raise ValueError("FabricResult carries no telemetry")
    traversals = _np(result.sent).astype(np.int64).sum(axis=1)
    # occupancy denominator: the run's active span, first injection to
    # last clock
    n = int(result.delivered)
    t0 = int(_np(result.log_inj)[:n].min()) if n else 0
    span = max(int(result.t_end) - t0, 1)
    occupancy = _np(tel.busy_ns).astype(np.float64) / float(span)
    return LinkLoad(
        traversals=traversals, occupancy=occupancy,
        backlog_steps=_np(tel.busy_steps).astype(np.int64).sum(axis=1),
        drops=_np(tel.q_drops).astype(np.int64).sum(axis=1),
        stalls=_np(tel.stall_steps).astype(np.int64).sum(axis=1))


def link_load_batch(batch) -> list[LinkLoad]:
    """Per-instance :class:`LinkLoad` roll-ups of one batched run (a
    ``network.FabricBatchResult``), batch order: each instance's
    counters equal its solo run's, so this is :func:`link_load` over the
    instance views."""
    return [link_load(batch.instance(i)) for i in range(batch.n_instances)]
