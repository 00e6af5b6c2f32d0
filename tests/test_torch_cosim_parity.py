"""The port's co-simulation held against the reference's, tick for tick,
on ``device="cpu"``.

The reference draws weights and drive from ``jax.random``, which PyTorch
cannot reproduce, so its weights (``_w_np``) go to the port's engine
through ``interop.cosim_weights_from_reference`` and its per-tick drive
(``uniform(fold_in(drive_key, tick)) < input_rate``, computed here) as a
bool array.  The local matrix products are float32 sums in another order
than XLA's, so membranes match to 1e-6 (``tests/test_kernels.py:100``)
and a trajectory may flip a spike only where a membrane lands within
1e-6 of the threshold: a whole-loop test that meets a divergence finds
its first tick and asserts exactly that, and holds everything before it
equal.  Integer fabric results are compared bit for bit with the
reference's ``network.assert_results_equal``."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import cosim as jc
from repro.core import network as jnet
from repro.core.fabric import QueuePolicy as JQueues
from repro.core.link import SERIAL_LVDS_TIMING as J_LVDS
from repro.core.router import AddressSpec as JAddr
from repro.core.router import ring_topology as j_ring
from repro.cosim import traffic_bridge as jtb
from repro.models import snn as jsnn
from repro_torch import cosim as tc
from repro_torch import interop
from repro_torch.core.fabric import QueuePolicy
from repro_torch.core.link import SERIAL_LVDS_TIMING
from repro_torch.core.router import AddressSpec, ring_topology
from repro_torch.cosim import traffic_bridge as ttb
from repro_torch.models import snn as tsnn
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"
TOL = 1e-6
KEY = jax.random.PRNGKey(3)


def ring_recurrent(mod, topo, addr, n_chips=4):
    pops = [mod.Population(f"p{i}", 128) for i in range(n_chips)]
    projs = []
    for i in range(n_chips):
        projs.append(mod.Projection(i, ((i + 1) % n_chips,), 0.4))
        projs.append(mod.Projection(i, ((i - 1) % n_chips,), 0.4))
        projs.append(mod.Projection(i, (i,), 0.3))
    return mod.place(pops, projs, topo(n_chips), addr=addr)


def fanout3(mod, topo, addr):
    """The fanout-3 multicast placement of ``tests/test_cosim.py:227``."""
    pops = [mod.Population(f"p{i}") for i in range(4)]
    projs = [mod.Projection(0, (1, 2, 3), 0.5), mod.Projection(0, (0,), 0.3),
             mod.Projection(1, (0,), 0.4)]
    return mod.place(pops, projs, topo(4), addr=addr)


PLACEMENTS = {"ring_recurrent": ring_recurrent, "fanout3": fanout3}


@functools.cache
def _uniform(shape):
    return jax.jit(lambda k, t: jax.random.uniform(jax.random.fold_in(k, t),
                                                   shape))


def ref_drive(jeng, n_ticks):
    """(T, P, n) bool: the drive the reference engine draws each tick."""
    P, n = jeng.placement.n_pops, jeng.placement.neurons
    u = _uniform((P, n))
    return np.stack([np.asarray(u(jeng._drive_key, t)) < jeng.cfg.input_rate
                     for t in range(n_ticks)])


def port_engine(jeng, tpl, cfg_kw, *, fabric=None):
    return tc.CosimEngine(
        tpl, tc.CosimConfig(**cfg_kw), fabric=fabric, device=CPU,
        weights=interop.cosim_weights_from_reference(jeng._w_np))


def first_divergence(jres, tres, v_th):
    """None when the two rasters are equal; else the first tick whose
    spikes differ, after asserting every differing neuron there sits
    within TOL of the threshold (the side that did not spike carries its
    un-reset update ``v'``)."""
    diff = jres.raster != tres.raster
    if not diff.any():
        return None
    t0 = int(np.flatnonzero(diff.any(axis=(1, 2)))[0])
    d = diff[t0]
    v_pre = np.where(jres.raster[t0] == 0, jres.v[t0], tres.v[t0])[d]
    print(f"spike trajectories diverge at tick {t0} on {int(d.sum())} "
          f"neuron(s), |v' - v_th| = {np.abs(v_pre - v_th).tolist()}")
    assert np.all(np.abs(v_pre - v_th) <= TOL), (t0, v_pre)
    return t0


def assert_runs_match(jres, tres, v_th, n_ticks):
    """Everything the two runs report, up to a near-threshold divergence
    (whose tick is excluded, with every later one)."""
    t0 = first_divergence(jres, tres, v_th)
    upto = n_ticks if t0 is None else t0
    ok = slice(0, upto)
    assert np.allclose(jres.v[ok], tres.v[ok], rtol=0, atol=TOL)
    for f in ("spikes", "offered", "injected", "delivered", "drops"):
        assert np.array_equal(getattr(jres, f)[ok], getattr(tres, f)[ok]), f
    jfr = [(t, r) for t, r in jres.fabric_results if t < upto]
    tfr = [(t, r) for t, r in tres.fabric_results if t < upto]
    assert [t for t, _ in jfr] == [t for t, _ in tfr]
    for (t, a), (_, b) in zip(jfr, tfr):
        jnet.assert_results_equal(b, a, f"tick {t}")
    if t0 is None:
        assert np.array_equal(jres.latency_ns, tres.latency_ns)
        assert np.array_equal(jres.sent, tres.sent)
        assert (jres.telemetry is None) == (tres.telemetry is None)
        for f in () if jres.telemetry is None else jres.telemetry._fields:
            assert np.array_equal(getattr(jres.telemetry, f),
                                  getattr(tres.telemetry, f)), f
        assert tsnn.fabric_report(tres, n_ticks) == pytest.approx(
            jsnn.fabric_report(jres, n_ticks))
    return t0


# --- teacher-forced steps -------------------------------------------------

def test_cosim_step_teacher_forced():
    """The reference runs its closed loop; at every tick its (v, spikes,
    feedback, drive) go into both steps, its spikes into both packers
    and its fabric result into both scatters."""
    jpl = ring_recurrent(jc, j_ring, JAddr())
    tpl = ring_recurrent(tc, ring_topology, AddressSpec())
    jfab = jpl.fabric(queues=JQueues(capacity=128, flow="credit"))
    jeng = jc.CosimEngine(jpl, fabric=jfab, key=KEY)
    # the same weights and drive keys; v_th = inf returns v' un-reset
    jpre = jc.CosimEngine(jpl, jc.CosimConfig(v_th=float("inf")), key=KEY)
    teng = port_engine(jeng, tpl, {})
    P, n = jpl.n_pops, jpl.neurons
    v = spikes = np.zeros((P, n), np.float32)
    jpend, tpend = {}, {}
    near = flips = 0
    T = 10
    drives = ref_drive(jeng, T)
    for tick in range(T):
        fb = jpend.pop(tick, np.zeros((P, n), np.float32))
        tfb = tpend.pop(tick, np.zeros((P, n), np.float32))
        assert np.array_equal(fb, tfb), tick
        key_t = jax.random.fold_in(jeng._drive_key, tick)
        jv, js = map(np.asarray, jeng._step(v, spikes, fb, key_t))
        v_pre = np.asarray(jpre._step(v, spikes, fb, key_t)[0])
        tv, ts = (a.numpy() for a in teng._step(
            *(torch.from_numpy(np.array(a)) for a in (v, spikes, fb)),
            torch.from_numpy(drives[tick])))
        close = np.abs(v_pre - 1.0) <= TOL
        near += int(close.sum())
        flips += int((js != ts).sum())
        assert np.array_equal(js[~close], ts[~close]), tick
        same = js == ts
        assert np.allclose(jv[same], tv[same], rtol=0, atol=TOL), tick
        jev, tev = jeng.pack_events(js, tick), teng.pack_events(js, tick)
        assert (jev is None) == (tev is None)
        if jev is not None:
            for f in ("words", "proj", "neuron"):
                assert np.array_equal(getattr(jev, f), getattr(tev, f)), f
            for f in ("src", "t", "dest"):
                assert np.array_equal(np.asarray(getattr(jev.spec, f)),
                                      getattr(tev.spec, f).numpy()), f
            res = jfab.run(jev.spec)
            jeng._scatter(jev, res, tick, jpend)
            teng._scatter(tev, jax.tree.map(np.asarray, res), tick, tpend)
        v, spikes = jv, js
    print(f"near-threshold neurons over {T} ticks: {near}, of which "
          f"{flips} spiked differently")


# --- whole loops ------------------------------------------------------------

@functools.cache
def reference_run(name, n_ticks, cfg_items=(), timing=None):
    jpl = PLACEMENTS[name](jc, j_ring, JAddr())
    kw = {} if timing is None else {"timing": J_LVDS}
    jfab = jpl.fabric(queues=JQueues(capacity=128, flow="credit"), **kw)
    jeng = jc.CosimEngine(jpl, jc.CosimConfig(**dict(cfg_items)),
                          fabric=jfab, key=KEY)
    return jeng, jeng.run(n_ticks, record_state=True, record_fabric=True,
                          collect_events=True)


@pytest.mark.parametrize("name,cfg_items", [
    ("ring_recurrent", ()),
    ("fanout3", (("input_rate", 0.08),)),
])
@pytest.mark.parametrize("engine", ["pallas", "reference"])
def test_closed_loop_matches_reference(name, cfg_items, engine):
    """8 closed-loop ticks, credit capacity 128: spikes, per-tick
    counters, latencies, link counts, telemetry and every tick's
    FabricResult."""
    T = 8
    jeng, jres = reference_run(name, T, cfg_items)
    tpl = PLACEMENTS[name](tc, ring_topology, AddressSpec())
    fab = tpl.fabric(engine=engine,
                     queues=QueuePolicy(capacity=128, flow="credit"),
                     device=CPU)
    tres = port_engine(jeng, tpl, dict(cfg_items), fabric=fab).run(
        T, record_state=True, record_fabric=True,
        drive=ref_drive(jeng, T))
    assert tres.conservation_exact and int(tres.drops.sum()) == 0
    assert int(tres.delivered.sum()) > 0
    t0 = assert_runs_match(jres, tres, 1.0, T)
    if name == "fanout3" and t0 is None:
        assert np.array_equal(tres.injected,
                              tres.offered + 2 * np.asarray(
                                  [int((e.proj == 0).sum())
                                   for e in jres.events]))


def test_measured_feedback_matches_reference():
    """Slow serial links and a 600 ns tick: deliveries land past tick
    boundaries and feed back at the tick the fabric measured."""
    T = 6
    cfg_items = (("feedback", "measured"), ("tick_dt_ns", 600))
    jeng, jres = reference_run("ring_recurrent", T, cfg_items,
                               timing="lvds")
    assert int((jres.latency_ns >= 600).sum()) > 0
    tpl = ring_recurrent(tc, ring_topology, AddressSpec())
    fab = tpl.fabric(timing=SERIAL_LVDS_TIMING,
                     queues=QueuePolicy(capacity=128, flow="credit"),
                     device=CPU)
    tres = port_engine(jeng, tpl, dict(cfg_items), fabric=fab).run(
        T, record_state=True, record_fabric=True,
        drive=ref_drive(jeng, T))
    assert_runs_match(jres, tres, 1.0, T)


def test_open_loop_matches_reference():
    """feedback="none": the reference's open loop and the port's, and the
    port's reference_rollout, on the reference's weights and drive."""
    T = 12
    jpl = ring_recurrent(jc, j_ring, JAddr())
    jeng = jc.CosimEngine(jpl, jc.CosimConfig(feedback="none"), key=KEY)
    jres = jeng.run(T, record_state=True)
    teng = port_engine(jeng, ring_recurrent(tc, ring_topology,
                                            AddressSpec()),
                       {"feedback": "none"})
    drive = ref_drive(jeng, T)
    tres = teng.run(T, record_state=True, drive=drive)
    roll = tc.reference_rollout(teng, T, record_state=True, drive=drive)
    assert np.array_equal(tres.v.view(np.int32), roll.v.view(np.int32))
    assert_runs_match(jres, tres, 1.0, T)


@pytest.mark.parametrize("mode", ["feedforward", "recurrent"])
def test_spike_traffic_matches_reference(mode):
    """The bridge's spec on the reference's weights and drive: equal, or
    equal up to a near-threshold divergence of the rollout."""
    n_chips, epc, max_ticks = 8, 16, 64
    key = jax.random.PRNGKey(11)
    want = jtb.spike_traffic(key, n_chips, epc, mode=mode,
                             max_ticks=max_ticks)
    jeng = jc.CosimEngine(jtb._ring_placement(n_chips, mode),
                          jc.CosimConfig(input_rate=0.06,
                                         tick_dt_ns=jtb.TICK_DT_NS,
                                         feedback="none"), key=key)
    drive = ref_drive(jeng, max_ticks)
    got = ttb.spike_traffic(torch.Generator(), n_chips, epc, mode=mode,
                            max_ticks=max_ticks, device=CPU,
                            weights=jeng._w_np, drive=drive)
    w = [np.asarray(a) for a in want]
    g = [a.numpy() for a in got]
    if all(np.array_equal(a, b) for a, b in zip(w, g)):
        return
    # diverged: it must start at a near-threshold neuron, and the events
    # of every earlier tick must agree
    tpl = ttb._ring_placement(n_chips, mode)
    teng = port_engine(jeng, tpl, dict(input_rate=0.06,
                                       tick_dt_ns=ttb.TICK_DT_NS,
                                       feedback="none"))
    t0 = first_divergence(jeng.run(max_ticks, record_state=True),
                          teng.run(max_ticks, record_state=True,
                                   drive=drive), 1.0)
    assert t0 is not None
    early = w[1] < t0 * jtb.TICK_DT_NS
    assert all(np.array_equal(a[early], b[early]) for a, b in zip(w, g))
