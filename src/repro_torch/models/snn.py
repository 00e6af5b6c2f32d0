"""Paper-native application: a 2D chip-array spiking network whose
inter-chip spike traffic flows as Address-Events over shared
bi-directional AER buses (paper §IV, Fig. 6).

The PyTorch counterpart of the reference ``models/snn.py``.  Each "chip"
is a population of LIF neurons (``kernels.ops.lif_step``: the CUDA
kernel on the card, its plain version on the CPU).  Per tick every chip
integrates recurrent input and last tick's neighbour spikes, the LIF
update emits spikes, and the expected border-crossing event counts roll
up into bus figures.  ``link_report`` is the pre-fabric estimate from
those counts; ``fabric_report`` the measured roll-up of a real fabric or
co-simulation run.  Both bill energy through
``core.network.link_energy_pj``, the model the fabric bills through.

Randomness comes from an explicit ``torch.Generator`` (held in the
state), never JAX's keys, so the port cannot reproduce the reference's
draws; ``interop.snn_params_from_reference`` carries its weights across,
and ``snn_step`` / ``run_snn`` take the per-tick Poisson drive from the
caller (``drive=``) where it must match.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import events as ev
from ..core.link import PAPER_TIMING, LinkTiming
from ..core.telemetry import _np
from ..device import resolve_device
from ..kernels import ops as K

__all__ = ["SnnConfig", "SnnState", "init_snn", "snn_step", "run_snn",
           "spikes_to_events", "link_report", "fabric_report"]

_F32 = torch.float32


class SnnConfig(NamedTuple):
    grid: tuple = (4, 4)        # chips (rows, cols)
    neurons: int = 256          # per chip (rows of 128 lanes)
    decay: float = 0.9
    v_th: float = 1.0
    v_reset: float = 0.0
    w_scale: float = 0.3
    input_rate: float = 0.05    # Poisson drive per neuron per tick
    xchip_fanout: float = 0.1   # fraction of spikes that cross each border


class SnnState(NamedTuple):
    v: torch.Tensor             # (R, C, rows, 128) membranes
    spikes: torch.Tensor        # (R, C, rows, 128) last tick's spikes
    gen: torch.Generator        # drive draws (advanced by each tick)


def init_snn(cfg: SnnConfig, gen: torch.Generator, *,
             device=None) -> tuple[dict, SnnState]:
    """Random weights and a zero state.  The weights are drawn from
    ``gen`` on its own device and moved to ``device`` (``None``: the CUDA
    card), so one seed gives the same network on the CPU and the card."""
    dev = resolve_device(device)
    R, C = cfg.grid
    n = cfg.neurons
    rows = n // 128

    def draw():
        w = torch.randn((R, C, n, n), generator=gen, device=gen.device)
        return (w * cfg.w_scale / math.sqrt(n)).to(dev)

    params = {
        "w_rec": draw(),   # local recurrent weights per chip (dense n x n)
        "w_in": draw(),    # cross-chip projection: neighbour spikes in
    }
    zeros = torch.zeros((R, C, rows, 128), dtype=_F32, device=dev)
    state = SnnState(v=zeros, spikes=zeros.clone(), gen=gen)
    return params, state


def _neighbor_sum(spikes_flat: torch.Tensor) -> torch.Tensor:
    """Sum of 4-neighbourhood spike vectors with zero boundary.
    spikes_flat: (R, C, n)."""
    z = torch.zeros_like(spikes_flat[:1])
    north = torch.cat([spikes_flat[1:], z], dim=0)
    south = torch.cat([z, spikes_flat[:-1]], dim=0)
    zc = torch.zeros_like(spikes_flat[:, :1])
    east = torch.cat([spikes_flat[:, 1:], zc], dim=1)
    west = torch.cat([zc, spikes_flat[:, :-1]], dim=1)
    return north + south + east + west


def snn_step(params, cfg: SnnConfig, state: SnnState, drive=None):
    """One network tick.  Returns ``(state, tick_stats)``.

    ``drive``: this tick's (R, C, n) bool Poisson drive; ``None`` draws
    it from ``state.gen`` (``rand < input_rate``)."""
    R, C = cfg.grid
    n = cfg.neurons
    rows = n // 128
    dev = state.v.device
    if drive is None:
        g = state.gen
        drive = torch.rand((R, C, n), generator=g, device=g.device) \
            < cfg.input_rate
    drive = torch.as_tensor(drive).to(dev)
    if drive.shape != (R, C, n):
        raise ValueError(f"drive must be ({R}, {C}, {n}), got "
                         f"{tuple(drive.shape)}")

    sp_flat = state.spikes.reshape(R, C, n)
    i_local = torch.einsum("rcn,rcmn->rcm", sp_flat, params["w_rec"])
    i_nbr = torch.einsum("rcn,rcmn->rcm",
                         cfg.xchip_fanout * _neighbor_sum(sp_flat),
                         params["w_in"])
    i_ext = drive.to(_F32)
    i_syn = i_local + i_nbr + i_ext

    v2, spk = K.lif_step(state.v.reshape(R * C * rows, 128),
                         i_syn.reshape(R * C * rows, 128),
                         decay=cfg.decay, v_th=cfg.v_th,
                         v_reset=cfg.v_reset)
    v2 = v2.reshape(R, C, rows, 128)
    spk = spk.reshape(R, C, rows, 128)

    # inter-chip AER traffic: spikes crossing each border (expected count
    # under the fanout model) — E/W pairs share one bus, N/S pairs too.
    per_chip = spk.reshape(R, C, n).sum(-1)                  # (R, C)
    tick = {
        "spikes": per_chip.sum(),
        "rate": spk.mean(),
        "ew_events_lr": cfg.xchip_fanout * per_chip[:, :-1].sum(),
        "ew_events_rl": cfg.xchip_fanout * per_chip[:, 1:].sum(),
        "ns_events": 2 * cfg.xchip_fanout * per_chip[:-1, :].sum(),
        "busiest_chip": per_chip.max(),
    }
    return SnnState(v=v2, spikes=spk, gen=state.gen), tick


def run_snn(params, cfg: SnnConfig, state: SnnState, n_ticks: int,
            drive=None):
    """``n_ticks`` ticks as a host loop.  Returns the final state and
    the per-tick stats stacked along a leading (T,) axis, as the
    reference's ``lax.scan`` does.  ``drive``: (T, R, C, n) bool, one
    slice a tick (``None`` draws each from ``state.gen``)."""
    if drive is not None and len(drive) < n_ticks:
        raise ValueError(f"drive covers {len(drive)} ticks, need {n_ticks}")
    ticks = []
    for t in range(n_ticks):
        state, tick = snn_step(params, cfg, state,
                               None if drive is None else drive[t])
        ticks.append(tick)
    if not ticks:
        raise ValueError("run_snn needs n_ticks >= 1")
    return state, {k: torch.stack([tk[k] for tk in ticks])
                   for k in ticks[0]}


def spikes_to_events(spk_chip: torch.Tensor, core_id: int):
    """Dense spike vector (n,) -> ``(words (n,), count)``: the packed
    26-bit AE words of the active units first, zero-filled to ``n``
    (the reference's fixed-size ``nonzero``), and their count."""
    n = spk_chip.shape[0]
    active = spk_chip > 0
    idx = torch.zeros(n, dtype=torch.int64, device=spk_chip.device)
    nz = torch.nonzero(active).flatten()
    idx[:nz.numel()] = nz
    words = ev.pack_aer_address(torch.full_like(idx, core_id), idx)
    return words, active.sum()


def _bus_figures(ev_total: float, busy_ns: float, wall_ns: float,
                 energy_uj: float, timing: LinkTiming) -> dict:
    """The shared report shape: rate, occupancy, energy, wire economy."""
    return {
        "events_total": ev_total,
        "events_per_s": ev_total / (wall_ns * 1e-9),
        "bus_busy_frac": busy_ns / wall_ns,
        "energy_uj": energy_uj,
        "shared_bus_wires_per_link": timing.word_bits + 2,
        "dual_bus_wires_per_link": 2 * (timing.word_bits + 2),
        "throughput_headroom_x":
            (timing.bidir_throughput_mev_s() * 1e6) /
            max(ev_total / (wall_ns * 1e-9), 1.0),
    }


def link_report(ticks: dict, tick_dt_us: float = 100.0,
                timing: LinkTiming = PAPER_TIMING) -> dict:
    """Aggregate per-tick EXPECTED event counts into bus-level figures
    (the pre-fabric estimate; see the reference).  Busy time =
    events·t_req2req + two reversals a tick; energy through
    :func:`repro_torch.core.network.link_energy_pj`."""
    from ..core.network import link_energy_pj
    lr = _np(ticks["ew_events_lr"]).astype(float)
    rl = _np(ticks["ew_events_rl"]).astype(float)
    n_ticks = lr.shape[0]

    ev_total = float(lr.sum() + rl.sum()
                     + _np(ticks["ns_events"]).astype(float).sum())
    busy_ns = ev_total * timing.t_req2req_ns \
        + 2 * n_ticks * timing.t_reverse_penalty_ns
    wall_ns = n_ticks * tick_dt_us * 1e3
    return _bus_figures(ev_total, busy_ns, wall_ns,
                        link_energy_pj(np.asarray([ev_total]),
                                       timing) * 1e-6, timing)


def fabric_report(res, n_ticks: int, tick_dt_us: float = 100.0,
                  timing: LinkTiming = PAPER_TIMING) -> dict:
    """Bus-level figures of an ACTUAL fabric run — measured, not
    modelled.  ``res`` is a ``FabricResult`` or a ``cosim.CosimResult``
    (``sent`` (L, 2), ``delivered``, ``telemetry``); energy bills the
    counted transmissions, occupancy is the telemetry's per-link busy
    time against the run's wall clock."""
    from ..core.network import link_energy_pj
    sent = _np(res.sent)
    ev_total = float(_np(res.delivered).sum())
    wall_ns = n_ticks * tick_dt_us * 1e3
    busy = (_np(res.telemetry.busy_ns).astype(np.float64)
            if res.telemetry is not None
            else np.zeros(sent.shape[0]))
    rep = _bus_figures(ev_total, float(busy.mean()), wall_ns,
                       link_energy_pj(sent, timing) * 1e-6, timing)
    rep["max_link_busy_frac"] = float(busy.max(initial=0.0)) / wall_ns
    rep["traversals"] = int(sent.sum())
    return rep
