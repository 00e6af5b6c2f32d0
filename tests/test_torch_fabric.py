"""The slice end to end: the port's ``Fabric`` / ``simulate_fabric`` on
``device="cpu"`` against the reference's ``engine="reference"``.

Traffic is made with numpy and handed to both packages; results are
compared with the reference's own contract,
``network.assert_results_equal`` (``RESULT_FIELDS`` plus every telemetry
counter, bit for bit), with int32 dtypes checked besides.  The float
roll-ups are float32 in both packages and compared to 1e-6 relative
(the same integers divided once; only rounding could differ).

On the CPU the port's ``"pallas"`` engine runs its kernels' plain
versions, so this file holds the engine's step; the kernels themselves
are held against those plain versions on the card
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import network as net
from repro.core import traffic as jtr
from repro.core.link import PAPER_TIMING, SERIAL_LVDS_TIMING
from repro.core.link import per_link_timing as j_per_link_timing
from repro.core.router import (AddressSpec, MulticastTable, line_topology,
                               mesh2d_topology, ring_topology)
from repro.core.telemetry import link_load as j_link_load
from repro_torch import interop
from repro_torch.core import fabric as tfab
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import protocol_sim as tps
from repro_torch.core import router as trt
from repro_torch.core.telemetry import link_load as t_link_load
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

BIG = 2**30
CPU = "cpu"


# --- numpy traffic (the same arrays go to both packages) ---------------

def _other(rng, n, src):
    d = rng.integers(0, n - 1, src.shape)
    return d + (d >= src)


def np_traffic(pattern, n, epc, seed):
    rng = np.random.default_rng(seed)
    col = np.repeat(np.arange(n)[:, None], epc, 1)
    if pattern == "ping_pong":
        act = (n // 2) * 2
        col = col[:act]
        times = np.zeros_like(col)
        dest = np.where(col % 2 == 0, col + 1, col - 1)
    elif pattern == "bursty":
        nb = epc // 8
        starts = np.cumsum(rng.exponential(2000.0, (n, nb)).astype(int), 1)
        times = np.repeat(starts, 8, 1)
        dest = np.repeat(_other(rng, n, col[:, :nb]), 8, 1)
    else:
        times = np.cumsum(rng.exponential(200.0, (n, epc)).astype(int), 1)
        dest = _other(rng, n, col)
        if pattern == "hot_spot":
            hot = (rng.random((n, epc)) < 0.75) & (col != 0)
            dest = np.where(hot, 0, dest)
    return col.reshape(-1), times.reshape(-1), dest.reshape(-1)


def both(src, t, dest):
    arrs = [np.asarray(a, np.int32) for a in (src, t, dest)]
    jspec = jtr.TrafficSpec(*map(jnp.asarray, arrs))
    return jspec, interop.from_reference(traffic=arrs).traffic


def assert_same(jres, tres, ctx=""):
    got = interop.result_to_numpy(tres)
    net.assert_results_equal(jres, got, ctx)
    for f in net.RESULT_FIELDS:
        assert np.asarray(getattr(got, f)).dtype == np.int32, (ctx, f)
    for f in got.telemetry._fields:
        assert getattr(got.telemetry, f).dtype == np.int32, (ctx, f)


def run_both(topo_fn, spec_arrays, **kw):
    jspec, tspec = both(*spec_arrays)
    jres = net.simulate_fabric(topo_fn(), jspec, engine="reference", **kw)
    tres = tnet.simulate_fabric(topo_fn(), tspec, engine="pallas",
                                device=CPU, **kw)
    assert_same(jres, tres, repr(kw))
    return jres, tres


# --- N = 2 is the paper's link ----------------------------------------

@pytest.mark.parametrize("seed,initial_tx,max_burst",
                         [(0, 1, 0), (1, 0, 0), (2, 1, 1)])
def test_two_chip_fabric_is_simulate(seed, initial_tx, max_burst):
    rng = np.random.default_rng(seed)
    al = np.sort(rng.integers(0, 20_000, 30)).astype(np.int32)
    ar = np.sort(rng.integers(0, 20_000, 20)).astype(np.int32)
    src = np.r_[np.zeros(30), np.ones(20)]
    jres, tres = run_both(lambda: line_topology(2), (src, np.r_[al, ar],
                                                     1 - src),
                          initial_tx=initial_tx, max_burst=max_burst)
    sim = tps.simulate(al, ar, initial_tx=initial_tx, max_burst=max_burst,
                       device=CPU)
    assert int(tres.delivered) == 50
    assert int(tres.t_end) == int(sim.t_end)
    assert tres.sent.tolist() == [[int(sim.sent_l), int(sim.sent_r)]]
    assert int(tres.n_switches[0]) == int(sim.n_switches)
    act, t_tr = sim.trace.action.numpy(), sim.trace.t.numpy()
    n = int(tres.delivered)
    dlv, dst = tres.log_del[:n].numpy(), tres.log_dest[:n].numpy()
    np.testing.assert_array_equal(np.sort(t_tr[act == tps.A_TX_L]),
                                  np.sort(dlv[dst == 1]))
    np.testing.assert_array_equal(np.sort(t_tr[act == tps.A_TX_R]),
                                  np.sort(dlv[dst == 0]))


# --- topologies x patterns ---------------------------------------------

TOPOS = {"line3": lambda: line_topology(3), "ring4": lambda: ring_topology(4),
         "mesh2x3": lambda: mesh2d_topology(2, 3)}


@pytest.mark.parametrize("pattern", ["poisson", "bursty", "ping_pong",
                                     "hot_spot"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_topology_pattern_matrix(topo, pattern):
    n = TOPOS[topo]().n_chips
    jres, tres = run_both(TOPOS[topo], np_traffic(pattern, n, 8, 5))
    assert int(tres.delivered) == tres.injected
    thr = float(tnet.fabric_throughput_mev_s(tres))
    assert thr == pytest.approx(float(net.fabric_throughput_mev_s(jres)),
                                rel=1e-6)
    np.testing.assert_allclose(
        tnet.per_link_throughput_mev_s(tres).numpy(),
        np.asarray(net.per_link_throughput_mev_s(jres)), rtol=1e-6)
    assert tnet.latency_stats(tres) == net.latency_stats(jres)
    assert tnet.fabric_energy_pj(tres) == net.fabric_energy_pj(jres)


# --- flow control -------------------------------------------------------

@pytest.mark.parametrize("flow,cap,xon", [("drop", 10, None),
                                          ("credit", 3, None),
                                          ("onoff", 4, None),
                                          ("onoff", 4, 1)])
def test_flow_control_modes(flow, cap, xon):
    spec = np_traffic("hot_spot", 4, 8, 9)
    jres, tres = run_both(TOPOS["ring4"], spec, queue_capacity=cap,
                          flow_control=flow, xon=xon)
    if flow == "drop":
        assert int(tres.drops) > 0          # the drop path really ran
    else:
        assert int(tres.drops) == 0
        assert int(tres.delivered) == tres.injected
        assert int(tres.telemetry.stall_steps.sum()) > 0
    jl, tl_ = j_link_load(jres), t_link_load(tres)
    for f in jl._fields:
        np.testing.assert_array_equal(getattr(jl, f), getattr(tl_, f))


# --- multicast ------------------------------------------------------------

ADDR = AddressSpec()


def _mcast_case():
    """2x4 mesh; tag 0 from chip 0 branches at a non-root chip (K = 2)."""
    members = np.zeros((2, 8), bool)
    members[0, [3, 6]] = True
    members[1, [1, 2, 5, 7]] = True
    rng = np.random.default_rng(4)
    n = 24
    src = rng.integers(0, 8, n)
    src[:8] = 0
    t = np.sort(rng.integers(0, 3000, n))
    tag = rng.integers(0, 2, n)
    tag[:8] = 0
    dest = ADDR.pack_multicast(tag)
    uni = rng.random(n) < 0.3
    dest[uni] = ADDR.pack(_other(rng, 8, src[uni]))
    # per-source nondecreasing times: sort by (src, t)
    order = np.lexsort((t, src))
    return members, (src[order], t[order], dest[order])


@pytest.mark.parametrize("mode,cap", [("in_fabric", None),
                                      ("in_fabric", 9),
                                      ("source_expand", None)])
def test_multicast(mode, cap):
    members, arrays = _mcast_case()
    jspec, tspec = both(*arrays)
    jres = jfab.Fabric(mesh2d_topology(2, 4), addr=ADDR, engine="reference",
                       queues=jfab.QueuePolicy(capacity=cap),
                       mcast=jfab.MulticastPolicy(mode,
                                                  MulticastTable(members))
                       ).run(jspec)
    tf = tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                     queues=tfab.QueuePolicy(capacity=cap),
                     mcast=tfab.MulticastPolicy(
                         mode, trt.MulticastTable(members)),
                     engine="pallas", device=CPU)
    tres = tf.run(tspec)
    assert_same(jres, tres, mode)
    if mode == "in_fabric":
        assert tf.compiled_buckets[0][7] == 2     # K > 1: La = 2 * Lp
    if cap is None:
        assert int(tres.delivered) == tres.injected
        assert tnet.delivery_multiset(tres) == net.delivery_multiset(jres)
    else:                    # weighted subtree drops keep the books
        assert int(tres.drops) > 0
        assert int(tres.delivered) + int(tres.drops) == tres.injected


# --- timing, step bound, sentinel --------------------------------------

def test_heterogeneous_link_timing():
    assign = [0, 1, 0, 1]
    jt = j_per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING], assign)
    tt = tl.per_link_timing([tl.PAPER_TIMING, tl.SERIAL_LVDS_TIMING],
                            assign)
    jspec, tspec = both(*np_traffic("poisson", 4, 8, 2))
    jres = net.simulate_fabric(ring_topology(4), jspec, timing=jt,
                               engine="reference")
    tres = tnet.simulate_fabric(trt.ring_topology(4), tspec, timing=tt,
                                device=CPU)
    assert_same(jres, tres, "per-link timing")
    assert tnet.fabric_energy_pj(tres, tt) == net.fabric_energy_pj(jres, jt)


def test_binding_max_steps():
    jres, tres = run_both(TOPOS["ring4"], np_traffic("poisson", 4, 8, 3),
                          max_steps=40)
    assert 0 < int(tres.delivered) < tres.injected


@pytest.mark.parametrize("shift", [False, True])
def test_near_sentinel_switch_count_pinned(shift):
    """Ring-3, one event 2 -> 1: at t = 0 no link switches; shifted next
    to ``BIG_NS`` the reference counts one switch on link 1 (its
    switch count is not shift-invariant there).  The port reproduces
    the reference's output, not the invariant its test expects."""
    worst = PAPER_TIMING.t_req2req_ns + max(
        PAPER_TIMING.t_reverse_penalty_ns, PAPER_TIMING.t_idle_switch_ns)
    t0 = BIG - (3 + 4) * worst if shift else 0
    jres, tres = run_both(lambda: ring_topology(3), ([2], [t0], [1]))
    assert tres.n_switches.tolist() == ([0, 1, 0] if shift else [0, 0, 0])
    assert int(tres.log_del[0]) - t0 == 41


# --- the front door -----------------------------------------------------

@pytest.mark.parametrize("engine", ["pallas", "reference"])
def test_buckets_equal(engine):
    spec_arrays = np_traffic("poisson", 4, 8, 1)
    jspec, tspec = both(*spec_arrays)
    jcf = jfab.Fabric(ring_topology(4), engine=engine,
                      queues=jfab.QueuePolicy(max_burst=2)).compile(
                          jspec, warm=False)
    tcf = tfab.Fabric(trt.ring_topology(4), engine=engine,
                      queues=tfab.QueuePolicy(max_burst=2),
                      device=CPU).compile(tspec)
    assert tcf.bucket == jcf.bucket


def test_lifecycle_and_engine_names():
    fab = tfab.Fabric(trt.ring_topology(4), device=CPU)
    assert fab.engine.resolved == "ring"
    a = both(*np_traffic("poisson", 4, 8, 1))[1]
    b = both(*np_traffic("poisson", 4, 16, 1))[1]
    res = fab.compile(a).run(a)
    step = tfab.Fabric(trt.ring_topology(4), engine="pallas", device=CPU)
    cf = step.compile(a)
    tnet.assert_results_equal(res, cf.run(a), "ring vs pallas engine")
    with pytest.raises(ValueError, match="bucket"):
        cf.run(b)
    many = step.run_many([a, b])
    assert step.last_dispatch == "loop"      # two slot-engine buckets
    tnet.assert_results_equal(res, many[0])
    assert len(step.compiled_buckets) == 2
    ref = tfab.Fabric(trt.ring_topology(4), engine="reference",
                      device=CPU).run(a)
    tnet.assert_results_equal(res, ref, "ring vs reference engine")
    assert tfab.EngineSpec(name="ring").resolved == "ring"
    ms = tfab.EngineSpec(name="pallas", kernel="multistep")
    assert (ms.kernel, ms.chunk_size) == ("multistep", 128)
    for name in ("reference", "auto", "ring"):   # as the reference refuses
        with pytest.raises(ValueError, match="multistep"):
            tfab.EngineSpec(name=name, kernel="multistep")
    with pytest.raises(ValueError, match="chunk_size"):
        tfab.EngineSpec(name="pallas", kernel="multistep", chunk_size=0)
    with pytest.raises(ValueError, match="chunk_size"):
        tfab.EngineSpec(name="ring", chunk_size=0)
    with pytest.raises(ValueError):
        tfab.EngineSpec(name="pallas", kernel="nope")
    with pytest.raises(ValueError):
        tfab.EngineSpec(name="nope")


def _broken_ring(n):
    """Ring(n) tables whose routes to chip 3 loop 0 <-> 1: ``(next_link,
    out_side, hops)``."""
    rt = trt.RoutingTable.build(trt.ring_topology(n))
    nl, os_ = rt.next_link.copy(), rt.out_side.copy()
    nl[1, 3], os_[1, 3] = 0, 1
    nl[0, 3], os_[0, 3] = 0, 0
    return nl, os_, rt.hops


def test_broken_table_refused_under_lossless_flow():
    """Ring-6 with the 0 <-> 1 loop: the routes that terminate still
    form a cyclic channel-dependency graph, so credit flow refuses the
    table with the reference's message, naming the cycle; drop mode
    admits it."""
    from repro.core.router import RoutingTable as JRoutingTable
    arrs = _broken_ring(6)
    with pytest.raises(ValueError) as want:
        jfab.Fabric(ring_topology(6), routing=JRoutingTable(*arrs),
                    queues=jfab.QueuePolicy(capacity=4, flow="credit"))
    with pytest.raises(ValueError, match="channel-dependency") as got:
        tfab.Fabric(trt.ring_topology(6), routing=trt.RoutingTable(*arrs),
                    queues=tfab.QueuePolicy(capacity=4, flow="credit"),
                    device=CPU)
    assert str(got.value) == str(want.value)
    tfab.Fabric(trt.ring_topology(6), routing=trt.RoutingTable(*arrs),
                device=CPU)                            # drop mode admits


def test_broken_pairs_quarantined_under_lossless_flow():
    """Ring-5 with the same loop: the terminating routes' graph is
    acyclic, so credit flow admits the table, quarantines the broken
    pairs as the reference does, and refuses traffic that addresses
    them with the reference's message."""
    from repro.core.router import RoutingTable as JRoutingTable
    arrs = _broken_ring(5)
    jf = jfab.Fabric(ring_topology(5), routing=JRoutingTable(*arrs),
                     queues=jfab.QueuePolicy(capacity=4, flow="credit"))
    tf = tfab.Fabric(trt.ring_topology(5), routing=trt.RoutingTable(*arrs),
                     queues=tfab.QueuePolicy(capacity=4, flow="credit"),
                     device=CPU)
    np.testing.assert_array_equal(tf._nonterm_mask, jf._nonterm_mask)
    traffic = [np.asarray(a, np.int32) for a in ([2, 0], [0, 9], [4, 3])]
    with pytest.raises(ValueError) as want:
        jf.run(jtr.TrafficSpec(*map(jnp.asarray, traffic)))
    with pytest.raises(ValueError, match="quarantined") as got:
        tf.run(interop.from_reference(traffic=traffic).traffic)
    assert str(got.value) == str(want.value)


def test_results_stay_on_the_run_device():
    tres = tnet.simulate_fabric(trt.ring_topology(4),
                                both(*np_traffic("poisson", 4, 8, 1))[1],
                                device=CPU)
    assert tres.log_del.device == torch.device(CPU)
    assert tres.log_del.dtype == torch.int32


def test_kernel_operands_are_what_the_cuda_wrappers_take(monkeypatch):
    """Rehearse, on the CPU, the operand contract the CUDA wrappers
    check: every tensor the engine hands the queue step, and the packed
    carry, constants and base it hands the multi-step kernel, are int32
    and contiguous, with the shapes that wrapper checks — on one link
    (ring-2) and under multicast (K = 2), on both kernels."""
    from repro_torch.kernels import ops
    seen = []

    def guard(fn):
        def wrapped(*args):
            for a in args:
                assert a.dtype == torch.int32 and a.is_contiguous()
            seen.append(fn.__name__)
            return fn(*args)
        return wrapped

    def guard_ms(carry, consts, base, **kw):
        for a in (*carry, *consts, base):
            assert a.dtype == torch.int32 and a.is_contiguous()
        q_time, _, _, lanes, sides, logs, counters = carry
        links, route_out, route_del, route_wt, timing, params = consts
        # one leading instance axis on every operand (B = 1 for a solo run)
        b, nq, nc = q_time.shape
        n_chips, n_routes, k = route_out.shape[1:]
        L = nq // 2
        assert [tuple(t.shape) for t in carry] == [(b, nq, nc)] * 3 + [
            (b, 16, L), (b, 9, L, 2), logs.shape, (b, 2)]
        assert logs.shape[:2] == (b, 3) and b == 1
        assert [tuple(t.shape) for t in consts] == [
            (b, L, 2), (b, n_chips, n_routes, k), (b, n_chips, n_routes),
            (b, n_chips, n_routes, k), (b, 3, L), (b, 3)]
        assert base.shape == (1,) and kw["chunk"] >= 1
        seen.append("fabric_queue_multistep")
        return ms_fn(carry, consts, base, **kw)

    ms_fn = ops.fabric_queue_multistep
    monkeypatch.setattr(ops, "fabric_queue_scan",
                        guard(ops.fabric_queue_scan))
    monkeypatch.setattr(ops, "fabric_queue_update",
                        guard(ops.fabric_queue_update))
    monkeypatch.setattr(ops, "fabric_queue_multistep", guard_ms)
    multistep = tfab.EngineSpec("pallas", kernel="multistep", chunk_size=8)
    tspec = both([0, 0, 1], [0, 5, 9], [1, 1, 0])[1]
    members, arrays = _mcast_case()
    for engine in ("pallas", multistep):
        tfab.Fabric(trt.ring_topology(2), engine=engine,
                    device=CPU).run(tspec)
        tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                    mcast=tfab.MulticastPolicy(
                        "in_fabric", trt.MulticastTable(members)),
                    engine=engine, device=CPU).run(both(*arrays)[1],
                                                   max_steps=50)
    assert {"fabric_queue_scan", "fabric_queue_update",
            "fabric_queue_multistep"} <= set(seen)
