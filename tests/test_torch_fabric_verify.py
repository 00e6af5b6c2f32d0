"""The static verifier (``repro_torch.analysis.verify``, ``Fabric.verify``)
and the quarantine of broken route pairs, held against the reference
package's on the same tables and traffic.

Reports are compared exactly: every finding (severity, check, message),
the certificate, ``ok`` / ``deadlock_free``, the channel-dependency
graph's size and named cycle, ``route_cycles``, the clock bound and its
headroom, and the tree count; channel graphs edge for edge.  Runs that
the verifier admits (or, for the deadlock prediction, refuses) go
through the port on ``device="cpu"`` and are held field for field
against the reference's runs of the same traffic, which is made by the
reference's generators and handed to both packages.  The cases are the
reference's ``tests/test_fabric_verify.py``: the certificates, the
ring-4 bend whose broken pairs are quarantined, the all-clockwise
ring-4 that deadlocks, cyclic multicast trees and the tight per-link
clock budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import verify as jver
from repro.core import fabric as jfab
from repro.core import traffic as jtr
from repro.core.link import PAPER_TIMING as J_PAPER
from repro.core.link import per_link_timing as j_per_link_timing
from repro.core.router import (AddressSpec, MulticastTable, MulticastTree,
                               RoutingTable, line_topology, mesh2d_topology,
                               ring_topology)
from repro_torch import interop
from repro_torch.analysis import verify as tver
from repro_torch.core import fabric as tfab
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import router as trt

from _torch_cases import mesh_multicast_case

CPU = "cpu"
BIG = 2**30


def both(src, t, dest):
    arrs = [np.asarray(a, np.int32) for a in (src, t, dest)]
    return (jtr.TrafficSpec(*map(jnp.asarray, arrs)),
            interop.from_reference(traffic=arrs).traffic)


def poisson(key, n, epc):
    return both(*jtr.poisson(jax.random.PRNGKey(key), n, epc))


def same_report(jrep, trep):
    """Every field of the two packages' ``VerifyReport``s, exactly."""
    assert [(f.severity, f.check, f.message) for f in trep.findings] == \
        [(f.severity, f.check, f.message) for f in jrep.findings]
    for name in ("ok", "deadlock_free", "certificate", "cdg_nodes",
                 "cdg_edges", "cdg_cycle", "clock_bound_ns",
                 "clock_headroom_ns", "n_trees"):
        assert getattr(trep, name) == getattr(jrep, name), name
    np.testing.assert_array_equal(trep.route_cycles, jrep.route_cycles)
    assert trep.route_cycles.dtype == jrep.route_cycles.dtype
    assert trep.summary() == jrep.summary()
    assert [str(f) for f in trep.errors] == [str(f) for f in jrep.errors]


def table(mod, rt):
    return mod.RoutingTable(next_link=rt.next_link, out_side=rt.out_side,
                            hops=rt.hops)


def bent(rt):
    """Ring(4) dest-1 bend: routes (0,1) and (3,1) loop 0 <-> 3 forever,
    yet the surviving routes' channel-dependency graph is acyclic."""
    nl, os_ = rt.next_link.copy(), rt.out_side.copy()
    nl[0, 1], os_[0, 1] = 3, 1
    nl[3, 1], os_[3, 1] = 3, 0
    return nl, os_, rt.hops


def clockwise(rt):
    """All-clockwise ring table: one channel cycle."""
    n = rt.next_link.shape[0]
    nl, os_, hops = rt.next_link.copy(), rt.out_side.copy(), rt.hops.copy()
    for c in range(n):
        for d in range(n):
            if c != d:
                nl[c, d], os_[c, d], hops[c, d] = c, 0, (d - c) % n
    return nl, os_, hops


def fabric_pair(n, *, override=None, engine=None, **queues):
    """(reference Fabric, port Fabric) on ring(n), with ``override``
    applied to the BFS tables and ``queues`` the QueuePolicy."""
    jkw, tkw = {}, {}
    if override is not None:
        arrs = override(RoutingTable.build(ring_topology(n)))
        jkw["routing"] = RoutingTable(*arrs)
        tkw["routing"] = trt.RoutingTable(*arrs)
    if engine is not None:
        jkw["engine"] = tkw["engine"] = engine
    jf = jfab.Fabric(ring_topology(n), queues=jfab.QueuePolicy(**queues),
                     **jkw)
    tf = tfab.Fabric(trt.ring_topology(n), queues=tfab.QueuePolicy(**queues),
                     device=CPU, **tkw)
    return jf, tf


# --- certificates ---------------------------------------------------------

@pytest.mark.parametrize("n,queues,traffic", [
    (16, {}, None),
    (4, dict(capacity=8, flow="credit"), None),
    (16, dict(capacity=64, flow="credit"), None),
    (16, dict(capacity=64, flow="credit"), (2, 16, 24)),
    (8, {}, (3, 8, 24)),
    (8, dict(capacity=16, flow="onoff"), (5, 8, 16)),
    (12, dict(capacity=4, flow="credit"), (7, 12, 24)),
], ids=["drop16", "ring4-acyclic", "ring16-warns", "ring16-slack",
        "drop8-spec", "onoff8-spec", "ring12-saturable"])
def test_reports_equal_the_reference(n, queues, traffic):
    """Drop mode ('drop-mode'), ring-4's acyclic CDG ('acyclic-cdg'),
    ring-16's cyclic CDG (a warning without a spec, 'capacity-slack'
    with one) and a saturable ring-12 (refused): the same report."""
    jf, tf = fabric_pair(n, **queues)
    specs = poisson(*traffic) if traffic else (None, None)
    jrep, trep = jf.verify(specs[0]), tf.verify(specs[1])
    same_report(jrep, trep)
    assert tver.verify_fabric(tf, specs[1]).summary() == trep.summary()
    if trep.ok:
        assert trep.raise_if_failed() is trep
    else:
        with pytest.raises(ValueError) as got:
            trep.raise_if_failed()
        with pytest.raises(ValueError) as want:
            jrep.raise_if_failed()
        assert str(got.value) == str(want.value)


def test_certificates_of_the_reference_cases():
    assert fabric_pair(16)[1].verify().certificate == "drop-mode"
    rep = fabric_pair(4, capacity=8, flow="credit")[1].verify()
    assert rep.ok and rep.certificate == "acyclic-cdg" and \
        rep.cdg_cycle is None
    _, tf = fabric_pair(16, capacity=64, flow="credit")
    rep = tf.verify()
    assert rep.ok and not rep.deadlock_free and rep.cdg_cycle is not None
    rep = tf.verify(poisson(2, 16, 24)[1])
    assert rep.ok and rep.certificate == "capacity-slack"


# --- admitted configs drain -----------------------------------------------

@pytest.mark.parametrize("flow,cap", [("drop", None), ("credit", 64),
                                      ("onoff", 64)])
def test_admitted_configs_drain_as_the_reference(flow, cap):
    jspec, tspec = poisson(5, 8, 16)
    jf, tf = fabric_pair(8, capacity=cap, flow=flow)
    same_report(jf.verify(jspec), tf.verify(tspec))
    assert tf.verify(tspec).ok
    res = tf.run(tspec)
    tnet.assert_results_equal(res, jf.run(jspec), f"{flow} drains")
    assert int(res.delivered) == res.injected and int(res.drops) == 0


def test_step_bound_non_binding():
    jspec, tspec = poisson(7, 8, 16)
    jf, tf = fabric_pair(8, capacity=64, flow="credit")
    assert tf.verify(tspec).ok
    base = tf._plan(tspec, None).max_steps
    assert base == jf._plan(jspec, None).max_steps
    a = tf.run(tspec, max_steps=base)
    b = tf.run(tspec, max_steps=2 * base)
    tnet.assert_results_equal(a, b, "doubled bound")
    assert int(a.delivered) == a.injected
    rep_j = jf.verify(jspec, max_steps=base // 2)
    rep_t = tf.verify(tspec, max_steps=base // 2)
    same_report(rep_j, rep_t)
    assert "step-bound" in {f.check for f in rep_t.findings}


# --- a cyclic route graph with an acyclic CDG: quarantine ----------------

BENT_CLEAN = ([0, 1, 2, 3, 0, 2], [0, 0, 0, 0, 40, 40], [2, 3, 0, 2, 3, 1])


def test_bent_table_admitted_with_quarantine():
    jf, tf = fabric_pair(4, override=bent, capacity=8, flow="credit")
    jrep, trep = jf.verify(), tf.verify()
    same_report(jrep, trep)
    assert trep.ok and trep.deadlock_free
    assert trep.certificate == "acyclic-cdg"
    assert {tuple(p) for p in trep.route_cycles.tolist()} == {(0, 1), (3, 1)}
    np.testing.assert_array_equal(tf._nonterm_mask, jf._nonterm_mask)


@pytest.mark.parametrize("engine", [
    "reference", "ring", "pallas",
    tfab.EngineSpec("pallas", kernel="multistep", chunk_size=16)],
    ids=["reference", "ring", "step", "multistep"])
def test_bent_table_runs_lossless_on_every_engine(engine):
    """The clean six-event spec on every port engine, equal field for
    field to the reference's engine="reference" run."""
    jspec, tspec = both(*BENT_CLEAN)
    jf, _ = fabric_pair(4, override=bent, engine="reference", capacity=8,
                        flow="credit")
    want = jf.run(jspec)
    tf = tfab.Fabric(trt.ring_topology(4),
                     routing=trt.RoutingTable(*bent(RoutingTable.build(
                         ring_topology(4)))),
                     queues=tfab.QueuePolicy(capacity=8, flow="credit"),
                     engine=engine, device=CPU)
    got = tf.run(tspec)
    tnet.assert_results_equal(got, want, f"bent/{engine}")
    assert int(got.delivered) == got.injected and int(got.drops) == 0


@pytest.mark.parametrize("arrays", [([0], [0], [1]),
                                    ([0, 3, 2], [0, 5, 9], [1, 1, 0])])
def test_quarantined_traffic_refused(arrays):
    """At plan time (the reference's message, naming the pairs) and by
    ``verify(spec)`` (an error finding)."""
    jspec, tspec = both(*arrays)
    jf, tf = fabric_pair(4, override=bent, capacity=8, flow="credit")
    with pytest.raises(ValueError) as want:
        jf.run(jspec)
    with pytest.raises(ValueError, match="quarantined") as got:
        tf.run(tspec)
    assert str(got.value) == str(want.value)
    jrep, trep = jf.verify(jspec), tf.verify(tspec)
    same_report(jrep, trep)
    assert not trep.ok
    assert any(f.severity == "error" and f.check == "route-termination"
               for f in trep.findings)


def test_bent_table_admitted_in_drop_mode_without_quarantine():
    jf, tf = fabric_pair(4, override=bent)
    assert tf._nonterm_mask is None and jf._nonterm_mask is None
    same_report(jf.verify(), tf.verify())


# --- the deadlock prediction ---------------------------------------------

def _deadlock_arrays():
    src = np.repeat(np.arange(4), 8)
    return src, np.arange(32) * 5, (src + 3) % 4


def test_verify_names_the_saturable_cycle():
    jspec, tspec = both(*_deadlock_arrays())
    jf, tf = fabric_pair(4, override=clockwise, capacity=2, flow="credit")
    jrep, trep = jf.verify(jspec), tf.verify(tspec)
    same_report(jrep, trep)
    assert not trep.ok and not trep.deadlock_free
    err = [f for f in trep.findings
           if f.severity == "error" and f.check == "cdg-cycle"]
    for ch in ("L0:0->1", "L1:1->2", "L2:2->3", "L3:3->0"):
        assert ch in err[0].message


@pytest.mark.parametrize("engine", ["ring", "pallas"])
def test_stall_is_permanent(engine):
    """Delivery stops dead: 400 and 800 steps deliver the same, below
    injected, with no drops — equal to the reference's runs."""
    jspec, tspec = both(*_deadlock_arrays())
    jf, tf = fabric_pair(4, override=clockwise, engine=engine, capacity=2,
                         flow="credit")
    a, b = (tf.run(tspec, max_steps=m) for m in (400, 800))
    assert int(a.delivered) == int(b.delivered) < a.injected
    assert int(a.drops) == int(b.drops) == 0
    tnet.assert_results_equal(a, jf.run(jspec, max_steps=400), "400 steps")


def test_clean_table_same_capacity_drains():
    jspec, tspec = both(*_deadlock_arrays())
    jf, tf = fabric_pair(4, capacity=2, flow="credit")
    same_report(jf.verify(jspec), tf.verify(tspec))
    res = tf.run(tspec)
    assert int(res.delivered) == res.injected
    tnet.assert_results_equal(res, jf.run(jspec), "clean ring-4")


# --- multicast trees -----------------------------------------------------

def _cyclic_tree(tree_cls):
    """A hand-built ring(4) 'tree' whose edges 1 -> 2 -> 3 -> 1 loop."""
    edges = np.asarray([[0, 0, 0, 1], [1, 1, 0, 2], [2, 2, 0, 3],
                        [3, 1, 1, 1]], np.int32)
    deliver = np.zeros(4, bool)
    deliver[[1, 2, 3]] = True
    return tree_cls(src=0, edges=edges,
                             parent=np.asarray([-1, 0, 1, 2], np.int32),
                             deliver=deliver,
                             subtree=np.asarray([3, 2, 1, 1], np.int32))


def test_channel_graph_with_a_cyclic_tree():
    jg = jver.channel_graph(ring_topology(4),
                            RoutingTable.build(ring_topology(4)),
                            [_cyclic_tree(MulticastTree)])
    tg = tver.channel_graph(trt.ring_topology(4),
                            trt.RoutingTable.build(trt.ring_topology(4)),
                            [_cyclic_tree(trt.MulticastTree)])
    np.testing.assert_array_equal(tg.edges, jg.edges)
    assert tg.find_cycle() == jg.find_cycle()


@pytest.mark.parametrize("flow,cap", [("drop", None), ("credit", 12)])
def test_in_fabric_multicast_reports(flow, cap):
    """Trees of the 2x4 mesh's in-fabric multicast (K = 2): the same
    report, trees, demand grading and clock bound."""
    members, arrays = mesh_multicast_case(8 * 6)
    jspec, tspec = both(*arrays)
    jf = jfab.Fabric(mesh2d_topology(2, 4), addr=AddressSpec(),
                     queues=jfab.QueuePolicy(capacity=cap, flow=flow),
                     mcast=jfab.MulticastPolicy("in_fabric",
                                                MulticastTable(members)))
    tf = tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                     queues=tfab.QueuePolicy(capacity=cap, flow=flow),
                     mcast=tfab.MulticastPolicy(
                         "in_fabric", trt.MulticastTable(members)),
                     device=CPU)
    jrep, trep = jf.verify(jspec), tf.verify(tspec)
    same_report(jrep, trep)
    assert trep.n_trees > 1 and trep.ok


def test_multicast_without_table_is_a_finding():
    members, arrays = mesh_multicast_case(8)
    jspec, tspec = both(*arrays)
    jf = jfab.Fabric(mesh2d_topology(2, 4), addr=AddressSpec())
    tf = tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                     device=CPU)
    same_report(jf.verify(jspec), tf.verify(tspec))
    assert not tf.verify(tspec).ok


# --- channel graphs -------------------------------------------------------

@pytest.mark.parametrize("topo", ["ring4", "ring8", "ring16", "mesh3x4",
                                  "line5", "ring6-clockwise",
                                  "ring4-bent-excluded"])
def test_channel_graph_edges_equal(topo):
    name, _, variant = topo.partition("-")
    if name.startswith("ring"):
        n = int(name[4:])
        jt, tt = ring_topology(n), trt.ring_topology(n)
    elif name.startswith("mesh"):
        jt, tt = mesh2d_topology(3, 4), trt.mesh2d_topology(3, 4)
    else:
        jt, tt = line_topology(5), trt.line_topology(5)
    jrt = RoutingTable.build(jt)
    exclude = None
    if variant == "clockwise":
        jrt = RoutingTable(*clockwise(jrt))
    elif variant == "bent-excluded":
        jrt = RoutingTable(*bent(jrt))
        exclude = np.asarray([[0, 1], [3, 1]])
    jg = jver.channel_graph(jt, jrt, exclude_pairs=exclude)
    tg = tver.channel_graph(tt, table(trt, jrt), exclude_pairs=exclude)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    assert tg.edges.dtype == jg.edges.dtype == np.int32
    assert tg.n_channels == jg.n_channels and tg.n_edges == jg.n_edges
    cycle = tg.find_cycle()
    assert cycle == jg.find_cycle()
    if cycle is not None:
        assert tg.describe_cycle(cycle) == jg.describe_cycle(cycle)
        keep = np.ones(tg.n_channels, bool)
        keep[cycle[0]] = False
        np.testing.assert_array_equal(tg.restrict(keep).edges,
                                      jg.restrict(keep).edges)
    for q in range(tg.n_channels):
        assert tver.describe_channel(tt, q) == jver.describe_channel(jt, q)


def test_bfs_ring4_edges_exact():
    topo = trt.ring_topology(4)
    g = tver.channel_graph(topo, trt.RoutingTable.build(topo))
    assert g.find_cycle() is None
    assert sorted(map(tuple, g.edges.tolist())) == \
        [(0, 2), (1, 7), (3, 1), (6, 0)]
    assert tver.describe_channel(topo, 0) == "L0:0->1"
    assert tver.describe_channel(topo, 1) == "L0:1->0"


# --- the tight clock budget ------------------------------------------------

def _clock_fabrics():
    jt = j_per_link_timing([J_PAPER, J_PAPER.subword(26)], [0, 1])
    tt = tl.per_link_timing([tl.PAPER_TIMING, tl.PAPER_TIMING.subword(26)],
                            [0, 1])
    return (jfab.Fabric(line_topology(3), timing=jt),
            tfab.Fabric(trt.line_topology(3), timing=tt, device=CPU))


@pytest.mark.parametrize("srcs", [(0, 1), (1, 2)], ids=["fast", "slow"])
def test_clock_budget(srcs):
    """Traffic on the fast link near the sentinel is admitted and drains
    (the fabric-wide worst-cost bound would refuse it); the same times
    across the slow link are refused by verify() and by planning."""
    t_max = BIG - 1000
    a, b = srcs
    arrays = ([a, b] * 4, sorted(t_max - 70 * k for k in range(8)),
              [b, a] * 4)
    jspec, tspec = both(*arrays)
    jf, tf = _clock_fabrics()
    jrep, trep = jf.verify(jspec), tf.verify(tspec)
    same_report(jrep, trep)
    if srcs == (0, 1):
        assert trep.ok and 0 < trep.clock_headroom_ns
        with pytest.raises(ValueError, match="overflow"):
            tnet._overflow_guard(t_max, 8, tf._worst_cost)
        res = tf.run(tspec)
        tnet.assert_results_equal(res, jf.run(jspec), "fast link")
    else:
        assert not trep.ok and trep.clock_headroom_ns <= 0
        assert "clock-overflow" in {f.check for f in trep.findings}
        with pytest.raises(ValueError, match="overflow"):
            tf.run(tspec)
