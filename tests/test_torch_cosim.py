"""The port's closed-loop co-simulation on ``device="cpu"``: placement
compilation and validation against the reference, the engine's own
contracts (open loop equal to the standalone rollout bit for bit,
per-tick conservation, lossless credit flow, the loop's feedback really
changing the dynamics, the tick-budget and clock guards), its generator
contract, the traffic bridge and the bus reports.  Held tick for tick
against the reference in ``test_torch_cosim_parity.py``."""

import functools
import types

import numpy as np
import pytest
import torch

from repro import cosim as jc
from repro.core.router import AddressSpec as JAddr
from repro.core.router import ring_topology as j_ring
from repro_torch import cosim as tc
from repro_torch.core import events as tev
from repro_torch.core import network as tnet
from repro_torch.core.fabric import Fabric, QueuePolicy
from repro_torch.core.router import (AddressSpec, line_topology,
                                     ring_topology)
from repro_torch.cosim.engine import _MAX_BASE_NS
from repro_torch.cosim.traffic_bridge import SNN_PATTERNS, spike_traffic
from repro_torch.models import snn as tsnn
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"


def gen(seed=3):
    return torch.Generator().manual_seed(seed)


def ring_recurrent(mod, topo, addr, n_chips=4, neurons=128):
    pops = [mod.Population(f"p{i}", neurons) for i in range(n_chips)]
    projs = []
    for i in range(n_chips):
        projs.append(mod.Projection(i, ((i + 1) % n_chips,), 0.4))
        projs.append(mod.Projection(i, ((i - 1) % n_chips,), 0.4))
        projs.append(mod.Projection(i, (i,), 0.3))
    return mod.place(pops, projs, topo(n_chips), addr=addr)


def t_ring(n_chips=4):
    return ring_recurrent(tc, ring_topology, AddressSpec(), n_chips)


def credit_fabric(pl, cap=128):
    return pl.fabric(queues=QueuePolicy(capacity=cap, flow="credit"),
                     device=CPU)


# --- placement ----------------------------------------------------------

def _same_placement(a, b):
    assert a.n_pops == b.n_pops and a.neurons == b.neurons
    assert np.array_equal(a.chip_of, b.chip_of)
    assert a.local == b.local
    assert [tuple(r) for r in a.cross] == [tuple(r) for r in b.cross]
    assert a.posts_on == b.posts_on
    assert (a.mcast is None) == (b.mcast is None)
    if a.mcast is not None:
        assert np.array_equal(a.mcast.members, b.mcast.members)


def test_compile_ring_matches_reference():
    pl = t_ring()
    _same_placement(pl, ring_recurrent(jc, j_ring, JAddr()))
    assert len(pl.local) == 4 and len(pl.cross) == 8
    assert all(r.tag == -1 and r.fanout == 1 for r in pl.cross)
    for r in pl.cross:
        assert not pl.addr.is_multicast(r.dest_word)
        chip, _ = pl.addr.unpack(r.dest_word)
        assert int(chip) == r.chips[0]
        assert pl.posts_on[(r.proj, r.chips[0])] == \
            (pl.projections[r.proj].posts[0],)


def test_multicast_fanout_matches_reference():
    pops = [tc.Population(f"p{i}") for i in range(4)]
    pl = tc.place(pops, [tc.Projection(0, (1, 2, 3), 0.4)],
                  ring_topology(4), addr=AddressSpec())
    jpl = jc.place([jc.Population(f"p{i}") for i in range(4)],
                   [jc.Projection(0, (1, 2, 3), 0.4)], j_ring(4),
                   addr=JAddr())
    _same_placement(pl, jpl)
    (r,) = pl.cross
    assert r.tag == 0 and r.chips == (1, 2, 3) and r.fanout == 3
    fab = pl.fabric(device=CPU)        # auto-attaches the in_fabric table
    assert fab.mcast is not None and fab.mcast_policy.mode == "in_fabric"
    assert fab.device == torch.device("cpu")


def test_strategies_and_pins():
    pops = [tc.Population(f"p{i}") for i in range(4)]
    projs = [tc.Projection(0, (1,))]
    topo = ring_topology(2)
    assert list(tc.place(pops, projs, topo).chip_of) == [0, 1, 0, 1]
    blk = tc.place(pops, projs, topo, strategy="block")
    assert list(blk.chip_of) == [0, 0, 1, 1]
    pin = tc.place(pops, projs, topo, chips=[1, 1, 0, 0])
    assert list(pin.chip_of) == [1, 1, 0, 0]
    assert len(blk.cross) == 0 and len(blk.local) == 1


P, PR = tc.Population, tc.Projection


@pytest.mark.parametrize("bad", [
    lambda: tc.place([], [], ring_topology(2)),
    lambda: tc.place([P("a", 100)], [], ring_topology(2)),
    lambda: tc.place([P("a"), P("b", 256)], [], ring_topology(2)),
    lambda: tc.place([P("a")], [], ring_topology(2), chips=[5]),
    lambda: tc.place([P("a")], [], ring_topology(2), chips=[0, 1]),
    lambda: tc.place([P("a")], [], ring_topology(2), strategy="scatter"),
    lambda: tc.place([P("a"), P("b")], [PR(0, ())], ring_topology(2)),
    lambda: tc.place([P("a"), P("b")], [PR(2, (0,))], ring_topology(2)),
    lambda: tc.place([P("a"), P("b")], [PR(0, (9,))], ring_topology(2)),
    lambda: tc.place([P(f"p{i}") for i in range(3)], [PR(0, (1, 2))],
                     ring_topology(3), addr=None),
    lambda: tc.place([P("a")], [], ring_topology(8),
                     addr=AddressSpec(chip_bits=2)),
])
def test_rejects(bad):
    with pytest.raises(ValueError):
        bad()


# --- engine contracts ---------------------------------------------------

def test_open_loop_matches_reference_rollout():
    eng = tc.CosimEngine(t_ring(), tc.CosimConfig(feedback="none"),
                         generator=gen(), device=CPU)
    ref = tc.reference_rollout(eng, 12, record_state=True)
    opn = eng.run(12, record_state=True)
    assert np.array_equal(ref.v.view(np.int32), opn.v.view(np.int32))
    assert np.array_equal(ref.raster, opn.raster)
    assert np.array_equal(ref.spikes, opn.spikes)
    assert opn.total_spikes > 0


def test_engine_argument_checks():
    pl = t_ring()
    eng = tc.CosimEngine(pl, tc.CosimConfig(feedback="next_tick"),
                         generator=gen(), device=CPU)
    with pytest.raises(ValueError, match="needs a fabric"):
        eng.run(2)
    with pytest.raises(ValueError, match="feedback"):
        tc.CosimEngine(pl, tc.CosimConfig(feedback="sometimes"),
                       device=CPU)
    with pytest.raises(ValueError, match="topology"):
        tc.CosimEngine(pl, fabric=Fabric(ring_topology(6), device=CPU),
                       device=CPU)
    mc = tc.place([P(f"p{i}") for i in range(4)], [PR(0, (1, 2, 3))],
                  ring_topology(4), addr=AddressSpec())
    with pytest.raises(ValueError, match="multicast"):
        tc.CosimEngine(mc, fabric=Fabric(ring_topology(4),
                                         addr=AddressSpec(), device=CPU),
                       device=CPU)
    other = types.SimpleNamespace(topo=pl.topo, mcast=None,
                                  device=torch.device("meta"))
    with pytest.raises(ValueError, match="fabric runs on"):
        tc.CosimEngine(pl, fabric=other, device=CPU)
    with pytest.raises(ValueError, match="weights"):
        tc.CosimEngine(pl, device=CPU, weights=np.zeros((3, 128, 128)))
    opn = tc.CosimEngine(pl, tc.CosimConfig(feedback="none"), device=CPU)
    with pytest.raises(ValueError, match="drive"):
        opn.run(3, drive=np.zeros((2, 4, 128), bool))


@functools.cache
def closed_ring_run():
    """12 closed-loop ticks of the ring-4 on a credit fabric."""
    pl = t_ring()
    return tc.CosimEngine(pl, fabric=credit_fabric(pl), generator=gen(),
                          device=CPU).run(12)


def test_closed_loop_conserves_and_diverges_from_open():
    """Credit flow: conservation every tick, no drops, everything
    delivered; and the fed-back current changes the spike trajectory
    against the open-loop control (same weights and drive)."""
    opn = tc.CosimEngine(t_ring(), tc.CosimConfig(feedback="none"),
                         generator=gen(), device=CPU).run(12)
    cls = closed_ring_run()
    assert cls.conservation_exact
    assert int(cls.drops.sum()) == 0
    assert int(cls.delivered.sum()) == int(cls.injected.sum()) > 0
    assert np.array_equal(cls.offered, cls.injected)     # all unicast
    assert int(np.abs(cls.spikes - opn.spikes).sum()) > 0
    assert cls.latency_ns.shape == (int(cls.delivered.sum()),)
    assert cls.telemetry is not None
    assert int(cls.sent.sum()) >= int(cls.delivered.sum())


def test_conservation_under_drops():
    """A many-to-one funnel on bounded drop-mode queues overflows; the
    dropped events still balance the books and never feed back."""
    pops = [P(f"p{i}") for i in range(8)]
    projs = [PR(i, (0,), 0.4) for i in range(1, 8)]
    projs += [PR(i, (i,), 0.3) for i in range(8)]
    pl = tc.place(pops, projs, line_topology(8), addr=AddressSpec())
    fab = pl.fabric(queues=QueuePolicy(capacity=32, flow="drop"),
                    device=CPU)
    res = tc.CosimEngine(pl, tc.CosimConfig(input_rate=0.1,
                                            feedback_scale=0.0),
                         fabric=fab, generator=gen(), device=CPU).run(2)
    assert int(res.drops.sum()) > 0
    assert res.conservation_exact


def test_tick_budget_and_clock_guards():
    pl = t_ring()
    eng = tc.CosimEngine(pl, tc.CosimConfig(input_rate=1.0, tick_dt_ns=60),
                         fabric=credit_fabric(pl), generator=gen(),
                         device=CPU)
    with pytest.raises(ValueError, match="unique-timestamp budget"):
        eng.run(2)
    spk = np.ones((4, 128), np.float32)
    last = (_MAX_BASE_NS - 1) // eng.cfg.tick_dt_ns
    assert eng.pack_events(np.zeros_like(spk), last) is None
    with pytest.raises(ValueError, match="overflows the int32 ns clock"):
        eng.pack_events(spk, last + 1)


def test_aer_words_and_event_specs():
    eng = tc.CosimEngine(t_ring(), tc.CosimConfig(feedback="none"),
                         generator=gen(), device=CPU)
    res = eng.run(6, collect_events=True)
    assert res.events
    for e in res.events:
        core, neuron = tev.unpack_aer_address(e.words)
        assert np.array_equal(core.numpy(), e.proj)
        assert np.array_equal(neuron.numpy(), e.neuron)
        assert int(e.words.max()) <= tev.AER_ADDR_MASK
        assert all(t.dtype == torch.int32 and t.device.type == "cpu"
                   for t in e.spec)
        assert np.array_equal(e.spec.t.numpy(),
                              e.base + np.arange(e.n_events))
    spec = eng.traffic(6)
    assert spec.n_events == sum(e.n_events for e in res.events)


def test_generator_contract():
    """Same seed, same network and trajectory; another seed, another.
    Weight std is w_scale / sqrt(n); the drive's rate is input_rate; and
    with zero weights, no leak and v_th 0.5 the spikes are the drive."""
    pl = t_ring()
    cfg = tc.CosimConfig(feedback="none")
    a = tc.CosimEngine(pl, cfg, generator=gen(5), device=CPU)
    b = tc.CosimEngine(pl, cfg, generator=gen(5), device=CPU)
    c = tc.CosimEngine(pl, cfg, generator=gen(6), device=CPU)
    assert np.array_equal(a._w_np, b._w_np)
    assert not np.array_equal(a._w_np, c._w_np)
    assert np.array_equal(a.run(8).spikes, b.run(8).spikes)
    for scale in (0.4, 0.3):
        w = a._w_np[[i for i, p in enumerate(pl.projections)
                     if p.w_scale == scale]]
        assert float(w.std()) == pytest.approx(scale / np.sqrt(128),
                                               rel=0.01)
    g = a._drive_gen()
    d = torch.stack([a._draw_drive(g) for _ in range(200)])
    n = d.numel()
    sd = np.sqrt(cfg.input_rate * (1 - cfg.input_rate) / n)
    assert abs(float(d.float().mean()) - cfg.input_rate) < 5 * sd
    z = tc.CosimEngine(pl, cfg._replace(decay=0.0, v_th=0.5),
                       generator=gen(5), device=CPU,
                       weights=np.zeros_like(a._w_np))
    res = z.run(20, record_state=True)
    g = z._drive_gen()
    want = torch.stack([z._draw_drive(g) for _ in range(20)]).numpy()
    assert np.array_equal(res.raster, want.astype(np.float32))


# --- traffic bridge and reports -------------------------------------------

def test_bridge_deterministic_and_sized():
    a = spike_traffic(gen(11), 8, 16, device=CPU)
    b = spike_traffic(gen(11), 8, 16, device=CPU)
    assert a.src.shape == (128,) and a.src.dtype == torch.int32
    for f in ("src", "t", "dest"):
        assert torch.equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", sorted(SNN_PATTERNS))
def test_patterns_fabric_ready(name):
    spec = SNN_PATTERNS[name](gen(5), 8, 12, device=CPU)
    src, dest, t = spec.src.numpy(), spec.dest.numpy(), spec.t.numpy()
    assert np.all(src != dest)
    assert np.all((dest >= 0) & (dest < 8))
    for s in range(8):
        assert np.all(np.diff(t[src == s]) >= 0)
    res = Fabric(ring_topology(8), device=CPU).run(spec)
    assert int(res.delivered) + int(res.drops) == int(res.injected)


def test_bridge_underrun_and_bad_mode():
    with pytest.raises(ValueError, match="underran"):
        spike_traffic(gen(0), 8, 10_000, max_ticks=3, device=CPU)
    with pytest.raises(ValueError, match="mode"):
        spike_traffic(gen(0), 8, 4, mode="chaotic", device=CPU)


def test_fabric_report_measures_the_run():
    res = closed_ring_run()
    rep = tsnn.fabric_report(res, 12, tick_dt_us=10.0)
    assert rep["events_total"] == float(res.delivered.sum())
    assert rep["energy_uj"] == pytest.approx(
        tnet.link_energy_pj(res.sent) * 1e-6)
    assert rep["energy_uj"] == pytest.approx(
        float(res.sent.sum()) * 11.0 * 1e-6)
    assert 0.0 <= rep["bus_busy_frac"] <= 1.0
    assert rep["max_link_busy_frac"] >= rep["bus_busy_frac"] > 0.0
    assert rep["traversals"] == int(res.sent.sum())
    assert rep["dual_bus_wires_per_link"] == \
        2 * rep["shared_bus_wires_per_link"]
    ticks = {"ew_events_lr": np.asarray([3.0, 2.0]),
             "ew_events_rl": np.asarray([1.0, 0.0]),
             "ns_events": np.asarray([4.0, 2.0])}
    assert tsnn.link_report(ticks)["energy_uj"] == \
        tnet.link_energy_pj(np.asarray([12.0])) * 1e-6
