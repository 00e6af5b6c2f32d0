"""Tick-phased closed-loop co-simulation: LIF populations on a fabric.

The PyTorch counterpart of the reference ``cosim/engine.py``.  One tick
has four phases:

  1. **integrate** — every population's membrane update runs as one
     fused LIF call (``kernels.ops.lif_step``: the CUDA kernel on the
     card) on the summed synaptic current: local recurrent input +
     external Poisson drive + the fabric feedback buffer of this tick;
  2. **pack** — spikes on populations with inter-chip projections
     become 26-bit Address-Events carrying ``(projection, neuron)``;
     the transport word is the compiled route destination, and every
     event gets a UNIQUE injection time ``tick * tick_dt_ns +
     position``, the identity the delivery log hands back;
  3. **transport** — the tick's events run through ``Fabric.run`` as
     one :class:`EventSpec` (zero-spike ticks skip the fabric);
  4. **scatter** — each delivered event's ``(log_inj, log_dest)`` maps
     back to its source neuron and target populations, and the
     projection's weight column accumulates into a FUTURE tick's
     feedback buffer (``feedback="next_tick"``, or the tick after the
     fabric's measured delivery time with ``feedback="measured"``).

``feedback="none"`` is the open-loop control, equal bit for bit to
:func:`reference_rollout`.  Phases 2 and 4 are host numpy, exactly as in
the reference; the spike matrix comes to the host once a tick, and the
fabric's results come back through ``interop.result_to_numpy``.

Randomness: weights (one ``(n, n)`` normal draw per projection, scaled
by ``w_scale / sqrt(n)``) and then a drive seed come from
``generator``, on its own device (a CPU generator by default, so one
seed gives one network on the CPU and the card); each run re-seeds a
drive generator from that seed and draws ``rand((P, n)) < input_rate``
once a tick, so every run of an engine sees the same drive.  The port
cannot reproduce the reference's ``jax.random`` draws, so it takes the
reference's weights (``weights=``, see
``interop.cosim_weights_from_reference``) and a per-tick drive
(``run(drive=)``) from the caller where it must match.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import interop
from ..core import events as ev
from ..core import traffic as tr
from ..core.fabric import Fabric
from ..core.telemetry import Telemetry, _np, merge_telemetry
from ..device import resolve_device
from ..kernels import ops as K
from .placement import LANES, Placement

__all__ = ["CosimConfig", "CosimEngine", "CosimResult", "EventSpec",
           "reference_rollout"]

#: feedback modes: open-loop control / idealised next-tick / fabric-timed
FEEDBACK_MODES = ("none", "next_tick", "measured")

#: injection-time bases must stay far below the engines' BIG_NS sentinel
_MAX_BASE_NS = 1 << 29

_F32 = torch.float32


class CosimConfig(NamedTuple):
    """Dynamics + loop parameters (placement-independent)."""
    decay: float = 0.9
    v_th: float = 1.0
    v_reset: float = 0.0
    input_rate: float = 0.05     # Poisson drive per neuron per tick
    tick_dt_ns: int = 10_000     # network tick period (10 kHz default)
    feedback: str = "next_tick"  # FEEDBACK_MODES
    feedback_scale: float = 1.0  # gain on fabric-delivered current


class EventSpec(NamedTuple):
    """One tick's spike traffic, ready for ``Fabric.run``: ``spec`` the
    transport view (int32 CPU tensors: src chip, unique time, routed
    dest word), ``words`` the 26-bit AER payload words, ``proj`` /
    ``neuron`` the per-event identity the scatter reads back via
    ``log_inj - base``."""
    tick: int
    base: int                 # injection-time base of this tick
    spec: tr.TrafficSpec
    words: np.ndarray         # (E,) uint32 packed (projection, neuron)
    proj: np.ndarray          # (E,) int32
    neuron: np.ndarray        # (E,) int32

    @property
    def n_events(self) -> int:
        return int(self.proj.shape[0])


class CosimResult(NamedTuple):
    """Per-tick trajectories of one co-simulation run (numpy)."""
    spikes: np.ndarray        # (T, P) per-population spike counts
    offered: np.ndarray       # (T,) events offered to the fabric
    injected: np.ndarray      # (T,) expected deliveries (post-fanout)
    delivered: np.ndarray     # (T,)
    drops: np.ndarray         # (T,)
    latency_ns: np.ndarray    # all delivered end-to-end latencies
    sent: np.ndarray          # (L, 2) summed link transmissions
    telemetry: Telemetry | None   # merged over all fabric ticks
    v: np.ndarray | None = None       # (T, P, n) with record_state
    raster: np.ndarray | None = None  # (T, P, n) with record_state
    events: tuple = ()        # per-tick EventSpecs (collect_events)
    fabric_results: tuple = ()  # (tick, numpy FabricResult) (record_fabric)

    @property
    def total_spikes(self) -> int:
        return int(self.spikes.sum())

    @property
    def conservation_exact(self) -> bool:
        """Per-tick ``delivered + drops == injected`` — every tick."""
        return bool(np.all(self.delivered + self.drops == self.injected))


class CosimEngine:
    """Closed-loop runner binding a :class:`Placement` to a fabric.

    ``fabric``: a port ``Fabric`` whose topology / address space match
    the placement (``placement.fabric(device=...)``), on the engine's
    device; ``None`` for open-loop runs.  ``device=None`` means the CUDA
    card (raises without one).  ``weights``: ``(n_proj, n, n)`` float32
    projection weights to use instead of drawing them."""

    def __init__(self, placement: Placement, cfg: CosimConfig = None,
                 *, fabric: Fabric = None,
                 generator: torch.Generator | None = None, device=None,
                 weights=None):
        self.placement = placement
        self.cfg = cfg if cfg is not None else CosimConfig()
        if self.cfg.feedback not in FEEDBACK_MODES:
            raise ValueError(f"feedback must be one of {FEEDBACK_MODES}, "
                             f"got {self.cfg.feedback!r}")
        if self.cfg.tick_dt_ns <= 0:
            raise ValueError("tick_dt_ns must be positive")
        self.device = resolve_device(device)
        self.fabric = fabric
        if fabric is not None:
            if fabric.topo.n_chips != placement.topo.n_chips:
                raise ValueError(
                    f"fabric topology ({fabric.topo.n_chips} chips) "
                    f"does not match the placement "
                    f"({placement.topo.n_chips} chips)")
            if (placement.mcast is not None) and fabric.mcast is None:
                raise ValueError("placement compiled multicast tags but "
                                 "the fabric has no multicast table — "
                                 "build it with placement.fabric(...)")
            if fabric.device != self.device:
                raise ValueError(f"fabric runs on {fabric.device} but the "
                                 f"engine on {self.device}")
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        n = placement.neurons
        n_proj = max(len(placement.projections), 1)
        if weights is None:
            w = torch.zeros((n_proj, n, n), dtype=_F32)
            for pi, proj in enumerate(placement.projections):
                w[pi] = torch.randn((n, n), generator=gen,
                                    device=gen.device).cpu() \
                    * (proj.w_scale / math.sqrt(n))
            self._w_np = w.numpy()
        else:
            self._w_np = np.ascontiguousarray(_np(weights), np.float32)
            if self._w_np.shape != (n_proj, n, n):
                raise ValueError(f"weights must be ({n_proj}, {n}, {n}), "
                                 f"got {self._w_np.shape}")
        self._drive_device = gen.device
        self._drive_seed = int(torch.randint(0, 2**62, (1,), generator=gen,
                                             device=gen.device))
        self._w = torch.from_numpy(self._w_np).to(self.device)

    # --- phase 1: the membrane update ------------------------------------

    def _drive_gen(self) -> torch.Generator:
        """A fresh generator of the run's drive stream."""
        return torch.Generator(device=self._drive_device).manual_seed(
            self._drive_seed)

    def _draw_drive(self, gen: torch.Generator) -> torch.Tensor:
        P, n = self.placement.n_pops, self.placement.neurons
        return torch.rand((P, n), generator=gen, device=gen.device) \
            < self.cfg.input_rate

    def _step(self, v, spikes, fb, drive):
        """One membrane update: ``(v, spikes)`` of the populations after
        local recurrent input, the (P, n) bool ``drive`` and the
        feedback buffer ``fb`` (all on the engine's device)."""
        P, n = self.placement.n_pops, self.placement.neurons
        c = self.cfg
        i_loc = torch.zeros((P, n), dtype=_F32, device=self.device)
        for (pi, pre, post) in self.placement.local:
            i_loc[post] += self._w[pi] @ spikes[pre]
        i_syn = i_loc + drive.to(_F32) + fb
        v2, spk = K.lif_step(v.reshape(P * (n // LANES), LANES),
                             i_syn.reshape(P * (n // LANES), LANES),
                             decay=c.decay, v_th=c.v_th, v_reset=c.v_reset)
        return v2.reshape(P, n), spk.reshape(P, n)

    def _drives(self, n_ticks: int, drive):
        """Per-tick drive tensors: the caller's (T, P, n) bool array, or
        the engine's own stream."""
        P, n = self.placement.n_pops, self.placement.neurons
        if drive is None:
            gen = self._drive_gen()
            for _ in range(n_ticks):
                yield self._draw_drive(gen).to(self.device)
            return
        drive = torch.as_tensor(drive)
        if drive.dim() != 3 or drive.shape[0] < n_ticks \
                or tuple(drive.shape[1:]) != (P, n):
            raise ValueError(f"drive must be ({n_ticks}+, {P}, {n}) bool, "
                             f"got {tuple(drive.shape)}")
        for t in range(n_ticks):
            yield drive[t].to(self.device)

    # --- phase 2: spikes -> one tick's EventSpec -------------------------

    def pack_events(self, spk: np.ndarray, tick: int) -> EventSpec | None:
        """Spike matrix (P, n) -> this tick's :class:`EventSpec`, or
        ``None`` when no inter-chip projection fired (the fabric refuses
        empty plans).  Event ``i`` of the tick injects at ``base + i``:
        unique, increasing times, so ``log_inj`` is the event's
        identity."""
        base = tick * self.cfg.tick_dt_ns
        if base >= _MAX_BASE_NS:
            raise ValueError(f"tick {tick} overflows the int32 ns clock "
                             f"(base {base} >= {_MAX_BASE_NS})")
        pl = self.placement
        srcs, dests, projs, neurons = [], [], [], []
        seq = 0
        for r in pl.cross:
            pre = pl.projections[r.proj].pre
            j = np.flatnonzero(spk[pre] > 0.0).astype(np.int32)
            if not j.size:
                continue
            srcs.append(np.full(j.size, r.src_chip, np.int32))
            dests.append(np.full(j.size, r.dest_word, np.int32))
            projs.append(np.full(j.size, r.proj, np.int32))
            neurons.append(j)
            seq += j.size
        if seq == 0:
            return None
        if seq >= self.cfg.tick_dt_ns:
            raise ValueError(
                f"{seq} events in one tick exceed the tick_dt_ns="
                f"{self.cfg.tick_dt_ns} unique-timestamp budget")
        proj = np.concatenate(projs)
        neuron = np.concatenate(neurons)
        t = np.arange(seq, dtype=np.int32) + np.int32(base)
        words = (((proj.astype(np.uint32) << np.uint32(16))
                  | neuron.astype(np.uint32)) & np.uint32(ev.AER_ADDR_MASK))
        spec = tr.TrafficSpec(src=torch.from_numpy(np.concatenate(srcs)),
                              t=torch.from_numpy(t),
                              dest=torch.from_numpy(np.concatenate(dests)))
        return EventSpec(tick=tick, base=base, spec=spec, words=words,
                         proj=proj, neuron=neuron)

    # --- phase 4: delivery log -> future feedback buffers ----------------

    def _scatter(self, evs: EventSpec, res, tick: int, pend: dict):
        """``res``: the tick's fabric result as numpy arrays."""
        ndel = int(res.delivered)
        if ndel == 0:
            return
        inj = res.log_inj[:ndel]
        chip = res.log_dest[:ndel]
        idx = inj - evs.base          # unique times -> event identity
        proj = evs.proj[idx]
        neuron = evs.neuron[idx]
        if self.cfg.feedback == "measured":
            dlv = res.log_del[:ndel]
            tt = dlv // self.cfg.tick_dt_ns + 1   # next update after
        else:                                     # arrival; >= tick + 1
            tt = np.full(ndel, tick + 1, np.int64)
        pl = self.placement
        P, n = pl.n_pops, pl.neurons
        cols = self._w_np[proj, :, neuron]        # (ndel, n) W[p][:, j]
        scale = np.float32(self.cfg.feedback_scale)
        n_proj = self._w_np.shape[0]
        group = (tt * n_proj + proj) * pl.topo.n_chips + chip
        for g in np.unique(group):
            sel = np.flatnonzero(group == g)
            d0 = sel[0]
            buf = pend.get(int(tt[d0]))
            if buf is None:
                buf = pend.setdefault(int(tt[d0]),
                                      np.zeros((P, n), np.float32))
            vec = cols[sel].sum(axis=0, dtype=np.float32) * scale
            for post in pl.posts_on[(int(proj[d0]), int(chip[d0]))]:
                buf[post] += vec

    # --- the loop ---------------------------------------------------------

    def run(self, n_ticks: int, *, record_state: bool = False,
            collect_events: bool = False, record_fabric: bool = False,
            drive=None) -> CosimResult:
        """``n_ticks`` ticks; ``drive`` optionally gives each tick's
        (P, n) bool Poisson drive as one (T, P, n) array."""
        pl, c = self.placement, self.cfg
        P, n = pl.n_pops, pl.neurons
        closed = self.fabric is not None and c.feedback != "none"
        if c.feedback != "none" and self.fabric is None:
            raise ValueError(f"feedback={c.feedback!r} needs a fabric "
                             f"(pass fabric= or feedback='none')")
        dev = self.device
        v = torch.zeros((P, n), dtype=_F32, device=dev)
        spikes = torch.zeros((P, n), dtype=_F32, device=dev)
        zero_fb = torch.zeros((P, n), dtype=_F32, device=dev)
        pend: dict[int, np.ndarray] = {}
        spk_counts = np.zeros((n_ticks, P), np.int64)
        offered = np.zeros(n_ticks, np.int64)
        injected = np.zeros(n_ticks, np.int64)
        delivered = np.zeros(n_ticks, np.int64)
        drops = np.zeros(n_ticks, np.int64)
        lats: list[np.ndarray] = []
        sent = np.zeros((pl.topo.n_links, 2), np.int64)
        tele: list[Telemetry] = []
        v_hist = np.zeros((n_ticks, P, n), np.float32) \
            if record_state else None
        raster = np.zeros((n_ticks, P, n), np.float32) \
            if record_state else None
        events: list[EventSpec] = []
        fres: list = []
        for tick, drive_t in enumerate(self._drives(n_ticks, drive)):
            fb_np = pend.pop(tick, None)
            fb = zero_fb if fb_np is None else torch.from_numpy(fb_np).to(dev)
            v, spikes = self._step(v, spikes, fb, drive_t)
            spk_np = spikes.cpu().numpy()
            spk_counts[tick] = (spk_np > 0.0).sum(axis=1)
            if record_state:
                v_hist[tick] = v.cpu().numpy()
                raster[tick] = spk_np
            if not (closed or collect_events):
                continue
            evs = self.pack_events(spk_np, tick)
            if evs is None:
                continue
            offered[tick] = evs.n_events
            if collect_events:
                events.append(evs)
            if not closed:
                continue
            res = interop.result_to_numpy(self.fabric.run(evs.spec))
            injected[tick] = int(res.injected)
            delivered[tick] = int(res.delivered)
            drops[tick] = int(res.drops)
            ndel = int(res.delivered)
            lats.append((res.log_del[:ndel]
                         - res.log_inj[:ndel]).astype(np.int64))
            sent += res.sent.astype(np.int64)
            if res.telemetry is not None:
                tele.append(res.telemetry)
            if record_fabric:
                fres.append((tick, res))
            self._scatter(evs, res, tick, pend)
        return CosimResult(
            spikes=spk_counts, offered=offered, injected=injected,
            delivered=delivered, drops=drops,
            latency_ns=(np.concatenate(lats) if lats
                        else np.zeros(0, np.int64)),
            sent=sent,
            telemetry=merge_telemetry(tele) if tele else None,
            v=v_hist, raster=raster, events=tuple(events),
            fabric_results=tuple(fres))

    def traffic(self, n_ticks: int) -> tr.TrafficSpec:
        """The spike-driven workload of an open-loop rollout as ONE flat
        ``TrafficSpec`` (int32 CPU tensors) — what the traffic bridge
        hands to sweeps.  Transport-independent: no fabric runs."""
        res = self.run(n_ticks, collect_events=True)
        if not res.events:
            raise ValueError(f"no inter-chip spikes in {n_ticks} ticks — "
                             f"raise input_rate or n_ticks")
        return tr.TrafficSpec(
            src=torch.cat([e.spec.src for e in res.events]),
            t=torch.cat([e.spec.t for e in res.events]),
            dest=torch.cat([e.spec.dest for e in res.events]))


def reference_rollout(engine: CosimEngine, n_ticks: int, *,
                      record_state: bool = False,
                      drive=None) -> CosimResult:
    """Standalone LIF rollout: the engine's dynamics with NO fabric, no
    placement routing, no feedback bookkeeping — the membrane update
    iterated with a zero feedback buffer.  ``engine.run`` with
    ``feedback="none"`` (and the same ``drive``) must match it bit for
    bit."""
    P, n = engine.placement.n_pops, engine.placement.neurons
    dev = engine.device
    v = torch.zeros((P, n), dtype=_F32, device=dev)
    spikes = torch.zeros((P, n), dtype=_F32, device=dev)
    fb = torch.zeros((P, n), dtype=_F32, device=dev)
    spk_counts = np.zeros((n_ticks, P), np.int64)
    v_hist = np.zeros((n_ticks, P, n), np.float32) if record_state else None
    raster = np.zeros((n_ticks, P, n), np.float32) if record_state else None
    for tick, drive_t in enumerate(engine._drives(n_ticks, drive)):
        v, spikes = engine._step(v, spikes, fb, drive_t)
        spk_np = spikes.cpu().numpy()
        spk_counts[tick] = (spk_np > 0.0).sum(axis=1)
        if record_state:
            v_hist[tick] = v.cpu().numpy()
            raster[tick] = spk_np
    z = np.zeros(n_ticks, np.int64)
    return CosimResult(spikes=spk_counts, offered=z, injected=z.copy(),
                       delivered=z.copy(), drops=z.copy(),
                       latency_ns=np.zeros(0, np.int64),
                       sent=np.zeros((engine.placement.topo.n_links, 2),
                                     np.int64),
                       telemetry=None, v=v_hist, raster=raster)
