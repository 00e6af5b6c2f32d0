"""The ring engine (``engine="ring"``, what ``"auto"`` resolves to) on
``device="cpu"`` against the reference package's ring engine and its
``engine="reference"``, field for field (``RESULT_FIELDS`` plus every
telemetry counter, int32 dtypes checked).

On the CPU the ring runner runs the same static-carry steps in a plain
loop that the card replays from a CUDA graph (``network._RingRun``); a
``CompiledFabric`` keeps its runner across runs, so a second run here
takes the same reuse path (operands copied into the runner's tensors)
as a second run on the card.  Traffic comes from the reference's
generators or from numpy by seed; the same arrays go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import fabric as jfab
from repro.core import network as jnet
from repro.core import protocol_sim as jps
from repro.core import traffic as jtr
from repro.core.link import PAPER_TIMING, SERIAL_LVDS_TIMING
from repro.core.link import per_link_timing as j_per_link_timing
from repro.core.router import (AddressSpec, MulticastTable, line_topology,
                               mesh2d_topology, ring_topology)
from repro_torch import interop
from repro_torch.core import fabric as tfab
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import protocol_sim as tps
from repro_torch.core import router as trt

from _torch_cases import hot_spot_arrays, mesh_multicast_case
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"

TOPOS = {"line4": (line_topology, trt.line_topology, (4,)),
         "mesh2x3": (mesh2d_topology, trt.mesh2d_topology, (2, 3)),
         "ring6": (ring_topology, trt.ring_topology, (6,)),
         "ring8": (ring_topology, trt.ring_topology, (8,))}


def topo_pair(name):
    jf, tf, args = TOPOS[name]
    return jf(*args), tf(*args)


def both(src, t, dest):
    arrs = [np.asarray(a, np.int32) for a in (src, t, dest)]
    return (jtr.TrafficSpec(*map(jnp.asarray, arrs)),
            interop.from_reference(traffic=arrs).traffic)


def jax_arrays(spec):
    return tuple(np.asarray(a) for a in spec)


def assert_same(jres, tres, ctx=""):
    got = interop.result_to_numpy(tres)
    jnet.assert_results_equal(jres, got, ctx)
    for f in jnet.RESULT_FIELDS:
        assert np.asarray(getattr(got, f)).dtype == np.int32, (ctx, f)
    for f in got.telemetry._fields:
        assert getattr(got.telemetry, f).dtype == np.int32, (ctx, f)


def ring_pair(topo, arrays, *, reference=True, **kw):
    """The port's ring run of ``arrays`` against the reference's ring
    run and (``reference``) its ``engine="reference"`` run."""
    jtopo, ttopo = topo
    jspec, tspec = both(*arrays)
    tres = tnet.simulate_fabric(ttopo, tspec, engine="ring", device=CPU,
                                **kw)
    jres = jnet.simulate_fabric(jtopo, jspec, engine="ring", **kw)
    assert_same(jres, tres, f"ring {kw}")
    if reference:
        kw.pop("chunk_size", None)
        assert_same(jnet.simulate_fabric(jtopo, jspec, engine="reference",
                                         **kw), tres, f"reference {kw}")
    return jres, tres


# --- the engine against both reference engines -------------------------

@pytest.mark.parametrize("pattern", sorted(jtr.PATTERNS))
def test_ring4_all_patterns(pattern):
    arrays = jax_arrays(jtr.PATTERNS[pattern](jax.random.PRNGKey(13), 4,
                                              24))
    mb = 1 if pattern == "ping_pong" else 0
    _, tres = ring_pair((ring_topology(4), trt.ring_topology(4)), arrays,
                        max_burst=mb)
    assert int(tres.delivered) == tres.injected


@pytest.mark.parametrize("max_burst", [0, 2])
@pytest.mark.parametrize("topo", ["line4", "mesh2x3", "ring6"])
def test_topologies(topo, max_burst):
    pair = topo_pair(topo)
    arrays = jax_arrays(jtr.poisson(jax.random.PRNGKey(5),
                                    pair[1].n_chips, 20))
    _, tres = ring_pair(pair, arrays, max_burst=max_burst,
                        reference=max_burst == 2)
    assert int(tres.delivered) == tres.injected


@pytest.mark.parametrize("initial_tx", [0, 1])
def test_two_chip_degenerates_to_paper_link(initial_tx):
    rng = np.random.default_rng(21)
    al = np.sort(rng.integers(0, 30_000, 40)).astype(np.int32)
    ar = np.sort(rng.integers(0, 30_000, 30)).astype(np.int32)
    src = np.r_[np.zeros(40), np.ones(30)]
    _, tres = ring_pair((line_topology(2), trt.line_topology(2)),
                        (src, np.r_[al, ar], 1 - src),
                        initial_tx=initial_tx, reference=False)
    for sim in (tps.simulate(al, ar, initial_tx=initial_tx, device=CPU),
                jps.simulate(jnp.asarray(al), jnp.asarray(ar),
                             initial_tx=initial_tx)):
        assert int(tres.delivered) == 70
        assert int(tres.t_end) == int(sim.t_end)
        assert tres.sent.tolist() == [[int(sim.sent_l), int(sim.sent_r)]]
        assert int(tres.n_switches[0]) == int(sim.n_switches)


def test_chunk_size_invariance():
    """Where the early-exit flag is read never shows in a drained run."""
    arrays = jax_arrays(jtr.poisson(jax.random.PRNGKey(3), 4, 24))
    pair = (ring_topology(4), trt.ring_topology(4))
    runs = [ring_pair(pair, arrays, chunk_size=c, reference=False)[1]
            for c in (1, 7, 128)]
    for c, res in zip((7, 128), runs[1:]):
        tnet.assert_results_equal(runs[0], res, f"chunk 1 vs {c}")
    assert int(runs[0].delivered) == runs[0].injected


@pytest.mark.parametrize("chunk,max_steps", [
    (8, 1), (8, 5), (8, 8), (8, 9), (8, 17), (8, 20),
    (16, 17), (16, 33), (128, 130)])
def test_binding_max_steps_is_exact(chunk, max_steps):
    """A bound inside a chunk and on its edges (step 0 runs alone, then
    chunks start at steps 1, 1 + chunk, ...): exactly ``max_steps``
    steps, as the reference's step-for-step slot scan."""
    arrays = jax_arrays(jtr.poisson(jax.random.PRNGKey(3), 4, 24))
    jtopo, ttopo = ring_topology(4), trt.ring_topology(4)
    jspec, tspec = both(*arrays)
    fab = tfab.Fabric(ttopo, engine=tfab.EngineSpec("ring",
                                                    chunk_size=chunk),
                      device=CPU)
    tres = fab.run(tspec, max_steps=max_steps)
    jref = jnet.simulate_fabric(jtopo, jspec, engine="reference",
                                max_steps=max_steps)
    assert_same(jref, tres, f"chunk {chunk}, {max_steps} steps")
    assert_same(jnet.simulate_fabric(jtopo, jspec, engine="ring",
                                     max_steps=max_steps), tres, "ring")
    assert int(tres.delivered) < tres.injected
    g = fab._compiled[fab.compiled_buckets[0]].graph
    assert g["steps"] == max_steps
    assert g["chunks"] == -(-(max_steps - 1) // chunk)


@pytest.mark.parametrize("flow,cap,xon", [("drop", 30, None),
                                          ("credit", 4, None),
                                          ("onoff", 6, None),
                                          ("onoff", 8, 3)])
def test_flow_control_modes(flow, cap, xon):
    arrays = hot_spot_arrays(8, 24, 300.0, 0.75, seed=3)
    _, tres = ring_pair(topo_pair("ring8"), arrays, queue_capacity=cap,
                        flow_control=flow, xon=xon,
                        reference=flow != "onoff" or xon is None)
    if flow == "drop":
        assert int(tres.drops) > 0
    else:
        assert int(tres.drops) == 0
        assert int(tres.delivered) == tres.injected
        assert int(tres.telemetry.stall_steps.sum()) > 0


def test_heterogeneous_link_timing():
    assign = [0, 1, 0, 0, 1, 0]
    jt = j_per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING], assign)
    tt = tl.per_link_timing([tl.PAPER_TIMING, tl.SERIAL_LVDS_TIMING],
                            assign)
    jspec, tspec = both(*jax_arrays(jtr.poisson(jax.random.PRNGKey(9), 6,
                                                20)))
    tres = tnet.simulate_fabric(trt.ring_topology(6), tspec, timing=tt,
                                max_burst=1, device=CPU)
    for eng in ("ring", "reference"):
        assert_same(jnet.simulate_fabric(ring_topology(6), jspec,
                                         timing=jt, max_burst=1,
                                         engine=eng), tres, eng)


@pytest.mark.parametrize("n,cap", [(8 * 12, None), (32, 20)])
def test_in_fabric_multicast_mesh(n, cap):
    """The 2x4 mesh whose tag-0 tree branches past its source (K = 2):
    weighted subtree drops at a tight capacity keep the books."""
    members, arrays = mesh_multicast_case(n)
    jspec, tspec = both(*arrays)
    jkw = dict(addr=AddressSpec(), queues=jfab.QueuePolicy(capacity=cap),
               mcast=jfab.MulticastPolicy("in_fabric",
                                          MulticastTable(members)))
    tkw = dict(addr=trt.AddressSpec(),
               queues=tfab.QueuePolicy(capacity=cap),
               mcast=tfab.MulticastPolicy("in_fabric",
                                          trt.MulticastTable(members)))
    tf = tfab.Fabric(trt.mesh2d_topology(2, 4), **tkw, device=CPU)
    tres = tf.run(tspec)
    for eng in ("ring", "reference"):
        assert_same(jfab.Fabric(mesh2d_topology(2, 4), engine=eng,
                                **jkw).run(jspec), tres, eng)
    plan = tf._plan(tspec, None)
    assert plan.route_out.shape[2] == 2 and plan.bucket[8] == 4
    if cap is None:
        assert int(tres.delivered) == tres.injected
    else:
        assert int(tres.drops) > 0
        assert int(tres.delivered) + int(tres.drops) == tres.injected


def test_unreachable_destination_refused():
    topo = trt.Topology(4, np.array([(0, 1), (2, 3)], np.int32))
    _, tspec = both([0], [0], [2])
    with pytest.raises(ValueError, match="unreachable"):
        tnet.simulate_fabric(topo, tspec, engine="ring", device=CPU)


# --- the front door: buckets, planners, runner reuse --------------------

def _bucket_cases():
    members, marr = mesh_multicast_case(8 * 12)
    return [
        ("ring4", (ring_topology(4), trt.ring_topology(4)), {}, {},
         jax_arrays(jtr.poisson(jax.random.PRNGKey(1), 4, 8))),
        ("ring16_credit", (ring_topology(16), trt.ring_topology(16)),
         dict(queues=jfab.QueuePolicy(capacity=64, flow="credit")),
         dict(queues=tfab.QueuePolicy(capacity=64, flow="credit")),
         hot_spot_arrays(16, 48, 300.0, 0.65, seed=2)),
        ("ring8_big_e", (ring_topology(8), trt.ring_topology(8)),
         dict(engine=jfab.EngineSpec("ring", chunk_size=32)),
         dict(engine=tfab.EngineSpec("ring", chunk_size=32)),
         jax_arrays(jtr.bursty(jax.random.PRNGKey(2), 8, 40))),
        ("mesh2x4_in_fabric", (mesh2d_topology(2, 4),
                               trt.mesh2d_topology(2, 4)),
         dict(addr=AddressSpec(), mcast=jfab.MulticastPolicy(
             "in_fabric", MulticastTable(members))),
         dict(addr=trt.AddressSpec(), mcast=tfab.MulticastPolicy(
             "in_fabric", trt.MulticastTable(members))), marr),
    ]


@pytest.mark.parametrize("case", range(4))
def test_bucket_and_planners_equal_reference(case):
    """The ring bucket tuple and the planners' arrays — in-edge ranks,
    stream quotas, the auto-width prefill — equal the reference's."""
    name, (jtopo, ttopo), jkw, tkw, arrays = _bucket_cases()[case]
    jspec, tspec = both(*arrays)
    jf, tf = jfab.Fabric(jtopo, **jkw), tfab.Fabric(ttopo, **tkw,
                                                    device=CPU)
    jp, tp = jf._plan(jspec, None), tf._plan(tspec, None)
    assert tp.bucket == jp.bucket, name
    assert tp.bucket[0] == "ring"
    for f in ("q_time", "q_dest", "q_inj", "sizes", "route_out",
              "route_del", "route_wt"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f"{name}: {f}")
    assert (tp.E, tp.max_steps, tp.cap, tp.fc, tp.xon) == (
        jp.E, jp.max_steps, jp.cap, jp.fc, jp.xon)
    rank_j, d_j = jnet._in_edge_ranks(jtopo)
    rank_t, d_t = tnet._in_edge_ranks(ttopo)
    np.testing.assert_array_equal(rank_t, rank_j)
    assert d_t == d_j and rank_t.dtype == np.int32
    rt = tf.routing_table
    src, _, dest = tnet._expand(tspec, tf.addr, tf.mcast)
    if tf.mcast_policy.mode == "source_expand":
        L = ttopo.n_links
        np.testing.assert_array_equal(
            tnet._stream_quota(rt, ttopo.links, rank_t, src, dest, L, d_t),
            jnet._stream_quota(jf.routing_table, jtopo.links, rank_j, src,
                               dest, L, d_j))


def test_small_planners_equal_reference():
    for n in (0, 1, 2, 3, 5, 64, 65, 2048, 2049):
        assert tnet._pow2ceil(n) == jnet._pow2ceil(n)
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(tnet._pad_to(a, (4, 5), -1),
                                  jnet._pad_to(a, (4, 5), -1))
    members, arrays = mesh_multicast_case(8 * 12)
    tf = tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                     mcast=tfab.MulticastPolicy(
                         "in_fabric", trt.MulticastTable(members)),
                     device=CPU)
    jf = jfab.Fabric(mesh2d_topology(2, 4), addr=AddressSpec(),
                     mcast=jfab.MulticastPolicy("in_fabric",
                                                MulticastTable(members)))
    (_, _, _, _, _, _, trees, counts, _, _) = tf._route_in_fabric(
        both(*arrays)[1])
    (_, _, _, _, _, _, jtrees, jcounts, _, _) = jf._route_in_fabric(
        both(*arrays)[0])
    L = tf.n_links
    np.testing.assert_array_equal(
        tnet._tree_stream_quota(trees, counts, tf._in_rank, L, tf._D),
        jnet._tree_stream_quota(jtrees, jcounts, jf._in_rank, L, jf._D))
    rng = np.random.default_rng(0)
    grp = rng.integers(0, 2 * L, 300)
    t = rng.integers(0, 5000, 300)
    for width in ("auto", None, 400):
        for x, y in zip(tnet._prefill(L, grp, t, t % 7, t, 300, width),
                        jnet._prefill(L, grp, t, t % 7, t, 300, width)):
            np.testing.assert_array_equal(x, y)


def test_runner_reuse_across_runs_of_one_bucket(monkeypatch):
    """compile() warms the bucket's solo runner on a zero-event plan;
    every later run of the bucket — other traffic, other multicast
    trees (other replication tables), other event counts, other fabrics
    — copies its operands into that runner's tensors and must equal the
    reference package's run."""
    members, _ = mesh_multicast_case(8)
    kw = dict(topo=trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
              mcast=tfab.MulticastPolicy("in_fabric",
                                         trt.MulticastTable(members)),
              queues=tfab.QueuePolicy(capacity=12, flow="credit"))
    jkw = dict(topo=mesh2d_topology(2, 4), addr=AddressSpec(),
               mcast=jfab.MulticastPolicy("in_fabric",
                                          MulticastTable(members)),
               queues=jfab.QueuePolicy(capacity=12, flow="credit"))
    monkeypatch.setattr(tnet, "_RUNNERS", {})
    fab = tfab.Fabric(**kw, device=CPU)
    pairs = [both(*mesh_multicast_case(n, seed=s)[1])
             for n, s in ((8 * 12, 8), (8 * 9, 3), (8 * 12, 5))]
    cf = fab.compile(pairs[0][1])
    assert len(tnet._RUNNERS) == 1 and cf.cache_size() == 1
    runner = next(iter(tnet._RUNNERS.values()))
    for i, (jspec, spec) in enumerate(pairs + pairs[:1]):
        assert fab._plan(spec, None).bucket == cf.bucket
        got = fab.run(spec)
        assert_same(jfab.Fabric(**jkw).run(jspec), got, f"run {i}")
        assert int(got.delivered) == got.injected
        other = tfab.Fabric(**kw, device=CPU).run(spec)   # same runner
        tnet.assert_results_equal(got, other, f"run {i}, another fabric")
    assert list(tnet._RUNNERS.values()) == [runner]
    assert cf.cache_size() == 1
    g = cf.graph
    assert g["captures"] == 0 and not g["captured"]     # no graph here
    # drained before the bound: step 0, then whole chunks, a flag read
    # before step 0 and after each chunk
    assert g["steps"] == 1 + 128 * g["chunks"]
    assert g["host_syncs"] == 1 + g["chunks"] and g["replays"] == 0


def test_auto_is_the_ring_engine():
    arrays = jax_arrays(jtr.hot_spot(jax.random.PRNGKey(4), 8, 24))
    jspec, tspec = both(*arrays)
    tres = tnet.simulate_fabric(trt.ring_topology(8), tspec, device=CPU)
    fab = tfab.Fabric(trt.ring_topology(8), device=CPU)
    assert fab.engine.resolved == "ring"
    assert fab.compile(tspec).bucket[0] == "ring"
    assert_same(jnet.simulate_fabric(ring_topology(8), jspec), tres, "auto")
