"""The congestion control plane (``repro_torch.core.adaptive``): epoch
partitions, merged results, congestion signals and adaptive runs, held
against the reference package's ``core/adaptive.py`` run for run.

The same traffic (the reference's generators, or numpy) goes through
both packages on ``device="cpu"``.  Partitions are compared slice for
slice, signals and table rebuilds value for value, and results with the
port's ``network.assert_results_equal`` (every ``RESULT_FIELDS`` entry
and telemetry counter, values and dtypes): each epoch's result and the
merged one, whose counters are int64 as the reference's are.  The
adaptive cases are the reference's ``tests/test_fabric_adaptive.py``:
ring-8 with 192 hot-spot events on every engine (the ring, the slot
engine over the plain step, ``"pallas"`` with ``kernel="step"`` and
``kernel="multistep"``, here their plain versions), the benchmark's
``ADAPTIVE_RING`` cell (ring-16, 768 events, capacity 48, 4 epochs,
alpha 4) on the ring engine, both policies, the event-driven trigger
and in-fabric multicast.  They are held against the reference's run,
never against its claim that adaptive beats static (which fails).  The
runner cache is checked flat at one runner over a 4-epoch run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import adaptive as jad
from repro.core import fabric as jfab
from repro.core import network as jnet
from repro.core import traffic as jtr
from repro.core.router import (AddressSpec, MulticastTable, ring_topology)
from repro.core.telemetry import link_load as j_link_load
from repro_torch import interop
from repro_torch.core import adaptive as tad
from repro_torch.core import fabric as tfab
from repro_torch.core import network as tnet
from repro_torch.core import router as trt
from repro_torch.core.telemetry import link_load as t_link_load
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"
#: the reference benchmark's ADAPTIVE_RING (benchmarks/fabric_sweep.py)
RING_CFG = dict(n_chips=16, key=3, epc=48, capacity=48,
                policy="min_backlog", epochs=4, alpha=4.0, ema=0.5)
ENGINES = {"ring": "ring", "reference": "reference", "step": "pallas",
           "multistep": tfab.EngineSpec("pallas", kernel="multistep")}


def both(src, t, dest):
    arrs = [np.asarray(a, np.int32) for a in (src, t, dest)]
    return (jtr.TrafficSpec(*map(jnp.asarray, arrs)),
            interop.from_reference(traffic=arrs).traffic)


def hot_spot(key, n, epc):
    return both(*jtr.hot_spot(jax.random.PRNGKey(key), n, epc))


def same_tables(a, b, ctx=""):
    for f in ("next_link", "out_side", "hops"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{ctx}: {f}")


def same_run(jfabric, jres, tfabric, tres, ctx):
    """The merged result, and each epoch's record: result, tables,
    rebuild flag and bucket (the reference's tuple, field for field; a
    slot engine held against the reference's engine="reference" shares
    its shapes and step bound, not its engine name)."""
    tnet.assert_results_equal(tres, jres, f"{ctx}: merged")
    jrep, trep = jfabric.last_report, tfabric.last_report
    assert trep.n_epochs == jrep.n_epochs
    same = (slice(None) if trep.buckets[0][0] == jrep.buckets[0][0]
            else slice(1, 8))
    assert [b[same] for b in trep.buckets] == \
        [b[same] for b in jrep.buckets]
    for e, (jr, tr) in enumerate(zip(jrep.records, trep.records)):
        tnet.assert_results_equal(tr.result, jr.result, f"{ctx}: epoch {e}")
        same_tables(jr.table, tr.table, f"{ctx}: epoch {e}")
        assert tr.rebuilt == jr.rebuilt
        assert tr.bucket[same] == jr.bucket[same]
        np.testing.assert_array_equal(tr.load.backlog_steps,
                                      jr.load.backlog_steps)
    tnet.assert_results_equal(trep.result, tres, f"{ctx}: report")
    assert not trep.recompiled


def adaptive_pair(n, *, engine="ring", queues=None, **policy):
    jq = jfab.QueuePolicy(**(queues or {}))
    tq = tfab.QueuePolicy(**(queues or {}))
    jeng = "reference" if engine != "ring" else "ring"
    return (jfab.Fabric(ring_topology(n), queues=jq, engine=jeng,
                        routing=jad.AdaptiveRouting(**policy)),
            tfab.Fabric(trt.ring_topology(n), queues=tq,
                        engine=ENGINES[engine], device=CPU,
                        routing=tad.AdaptiveRouting(**policy)))


# --- partitions and merges --------------------------------------------------

@pytest.mark.parametrize("epochs", [1, 3, 4, 7])
def test_partition_epochs_equal_the_reference(epochs):
    jspec, tspec = both(*jtr.poisson(jax.random.PRNGKey(2), 6, 20))
    jparts = jad.partition_epochs(jspec, epochs)
    tparts = tad.partition_epochs(tspec, epochs)
    assert len(tparts) == len(jparts)
    for jp, tp in zip(jparts, tparts):
        for f in ("src", "t", "dest"):
            got = getattr(tp, f).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(getattr(jp, f)))


def test_partition_more_epochs_than_events():
    jspec, tspec = both([0, 1, 2], [5, 1, 9], [1, 2, 0])
    parts = tad.partition_epochs(tspec, 7)
    assert [int(p.t[0]) for p in parts] == [1, 5, 9]
    assert len(jad.partition_epochs(jspec, 7)) == 3
    with pytest.raises(ValueError, match="epochs"):
        tad.partition_epochs(tspec, 0)


def test_merged_static_epochs_equal_the_reference():
    """``run_epochs`` under static tables: each epoch and the merge
    (int64 counters, int32 logs and clocks) against the reference's."""
    jspec, tspec = hot_spot(1, 8, 24)
    jf = jfab.Fabric(ring_topology(8), queues=jfab.QueuePolicy(capacity=32))
    tf = tfab.Fabric(trt.ring_topology(8),
                     queues=tfab.QueuePolicy(capacity=32), device=CPU)
    jres, tres = jf.run_epochs(jspec, epochs=3), tf.run_epochs(tspec,
                                                               epochs=3)
    same_run(jf, jres, tf, tres, "static epochs")
    got = interop.result_to_numpy(tres)
    for f in ("sent", "n_switches", "drops"):
        assert getattr(got, f).dtype == np.int64, f
    for f in ("delivered", "log_inj", "t_link", "t_end"):
        assert getattr(got, f).dtype == np.int32, f
    assert all(getattr(got.telemetry, f).dtype == np.int64
               for f in got.telemetry._fields)
    assert tres.log_del.device.type == CPU
    assert int(tres.delivered) + int(tres.drops) == tres.injected
    assert tres.offered == tspec.n_events


def test_merge_results_empty_raises():
    with pytest.raises(ValueError, match="no epoch"):
        tad.merge_results([], offered=0)


# --- the policy's pure functions ---------------------------------------------

def test_policy_validation_matches_the_reference():
    for kw in (dict(policy="fastest"), dict(epochs=0), dict(alpha=-1.0),
               dict(ema=0.0), dict(ema=1.5), dict(trigger="never"),
               dict(threshold=-1.0)):
        with pytest.raises(ValueError) as want:
            jad.AdaptiveRouting(**kw)
        with pytest.raises(ValueError) as got:
            tad.AdaptiveRouting(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("policy", ["min_backlog", "weighted_bfs"])
@pytest.mark.parametrize("flow", ["drop", "credit"])
def test_signal_and_next_table_equal_the_reference(policy, flow):
    """One run's telemetry through both packages' ``load_signal``,
    ``should_rebuild`` (both triggers) and ``next_table``."""
    jspec, tspec = hot_spot(0, 8, 16)
    cap = 16 if flow == "drop" else 4
    jres = jnet.simulate_fabric(ring_topology(8), jspec, queue_capacity=cap,
                                flow_control=flow)
    tres = tnet.simulate_fabric(trt.ring_topology(8), tspec,
                                queue_capacity=cap, flow_control=flow,
                                device=CPU)
    tnet.assert_results_equal(tres, jres, "the run")
    for alpha in (0.0, 0.5, 4.0):
        jp = jad.AdaptiveRouting(policy=policy, alpha=alpha)
        tp = tad.AdaptiveRouting(policy=policy, alpha=alpha)
        jsig, tsig = jp.load_signal(jres), tp.load_signal(tres)
        assert tsig.dtype == np.float64
        np.testing.assert_array_equal(tsig, jsig)
        same_tables(jp.next_table(ring_topology(8), jsig),
                    tp.next_table(trt.ring_topology(8), tsig), "next")
    for thr in (0.0, 1.5, 4.0, 100.0):
        jp = jad.AdaptiveRouting(trigger="backlog_burst", threshold=thr)
        tp = tad.AdaptiveRouting(trigger="backlog_burst", threshold=thr)
        assert tp.should_rebuild(t_link_load(tres)) == \
            jp.should_rebuild(j_link_load(jres))


# --- adaptive runs -----------------------------------------------------------

@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_merged_adaptive_equals_the_reference_on_every_engine(engine,
                                                              monkeypatch):
    """Ring-8, 192 hot-spot events, capacity 24, 4 epochs, alpha 4: the
    reference's run (its ring engine, or its engine="reference" for the
    slot engines), epoch for epoch, with one runner for the four epochs
    (a fresh runner cache, so the count is absolute).  The slot engines,
    which run every step of their bound, run under 400 steps an epoch
    here, which each epoch drains well inside (a bound that does not
    bind changes no result)."""
    monkeypatch.setattr(tnet, "_RUNNERS", {})
    jspec, tspec = hot_spot(4, 8, 24)
    jf, tf = adaptive_pair(8, engine=engine, queues=dict(capacity=24),
                           policy="min_backlog", epochs=4, alpha=4.0)
    bound = None if engine == "ring" else 400
    same_run(jf, jf.run(jspec, max_steps=bound), tf,
             tf.run(tspec, max_steps=bound), engine)
    rep = tf.last_report
    assert all(int(r.result.delivered) + int(r.result.drops)
               == r.result.injected for r in rep.records)
    assert [r.cache_size for r in rep.records] == [1] * 4
    assert len(tnet._RUNNERS) == 1


def test_adaptive_ring_cell(monkeypatch):
    """ADAPTIVE_RING on the ring engine: epoch for epoch the reference's
    run, the tables changed after epoch 0, epoch 0 equal to a static
    run of its slice, and one runner for all four epochs (a fresh
    runner cache, so the count is absolute)."""
    monkeypatch.setattr(tnet, "_RUNNERS", {})
    jspec, tspec = hot_spot(RING_CFG["key"], 16, RING_CFG["epc"])
    policy = {k: RING_CFG[k] for k in ("policy", "epochs", "alpha", "ema")}
    jf, tf = adaptive_pair(16, queues=dict(capacity=RING_CFG["capacity"]),
                           **policy)
    tres = tf.run(tspec)
    same_run(jf, jf.run(jspec), tf, tres, "ADAPTIVE_RING")
    rep = tf.last_report
    assert any(not np.array_equal(rep.records[0].table.next_link,
                                  r.table.next_link)
               for r in rep.records[1:])
    assert int(tres.delivered) + int(tres.drops) == tres.injected
    assert [r.cache_size for r in rep.records] == [1, 1, 1, 1]
    assert rep.cache_size == 1 and len(tnet._RUNNERS) == 1
    part0 = tad.partition_epochs(tspec, 4)[0]
    static0 = tfab.Fabric(trt.ring_topology(16), device=CPU,
                          queues=tfab.QueuePolicy(capacity=48)
                          )._run_single(part0)
    tnet.assert_results_equal(rep.records[0].result, static0, "epoch 0")
    assert tad.shared_max_steps(tf, tad.partition_epochs(tspec, 4),
                                detour_factor=5.0) == 12544


def test_alpha0_equals_static_epochs():
    jspec, tspec = hot_spot(4, 8, 24)
    _, tf = adaptive_pair(8, queues=dict(capacity=24), epochs=4, alpha=0.0)
    static = tfab.Fabric(trt.ring_topology(8), device=CPU,
                         queues=tfab.QueuePolicy(capacity=24))
    tnet.assert_results_equal(tf.run(tspec),
                              static.run_epochs(tspec, epochs=4), "alpha 0")


@pytest.mark.parametrize("policy", ["min_backlog", "weighted_bfs"])
def test_both_policies_equal_the_reference(policy):
    jspec, tspec = hot_spot(4, 8, 24)
    jf, tf = adaptive_pair(8, queues=dict(capacity=24), policy=policy,
                           epochs=2, alpha=2.0)
    same_run(jf, jf.run(jspec), tf, tf.run(tspec), policy)


def test_backlog_burst_trigger_equals_the_reference():
    """The event-driven trigger: which epochs rebuild, and the run."""
    jspec, tspec = hot_spot(2, 8, 24)
    jf, tf = adaptive_pair(8, queues=dict(capacity=16), epochs=4,
                           alpha=2.0, trigger="backlog_burst", threshold=2.0)
    same_run(jf, jf.run(jspec), tf, tf.run(tspec), "backlog_burst")


def test_run_epochs_overrides_the_policy_epochs():
    jspec, tspec = hot_spot(4, 8, 24)
    jf, tf = adaptive_pair(8, queues=dict(capacity=24), epochs=4, alpha=2.0)
    same_run(jf, jf.run_epochs(jspec, epochs=2), tf,
             tf.run_epochs(tspec, epochs=2), "run_epochs")
    assert tf.last_report.n_epochs == 2


def test_one_epoch_is_static():
    jspec, tspec = hot_spot(4, 8, 24)
    _, tf = adaptive_pair(8, queues=dict(capacity=24), epochs=1, alpha=8.0)
    static = tfab.Fabric(trt.ring_topology(8), device=CPU,
                         queues=tfab.QueuePolicy(capacity=24))
    tnet.assert_results_equal(tf.run(tspec),
                              static.run_epochs(tspec, epochs=1), "one")


def test_multicast_trees_regrow_per_epoch():
    """In-fabric multicast under weighted_bfs: the trees regrow on each
    epoch's tables; every epoch and the merge equal the reference's."""
    members = np.zeros((1, 8), bool)
    members[0, 2:7] = True
    rng = np.random.default_rng(9)
    n = 64
    arrays = (np.zeros(n), np.sort(rng.integers(0, 40_000, n)),
              AddressSpec().pack_multicast(np.zeros(n, np.int64)))
    jspec, tspec = both(*arrays)
    pol = dict(policy="weighted_bfs", epochs=4, alpha=2.0)
    jf = jfab.Fabric(ring_topology(8), addr=AddressSpec(),
                     mcast=jfab.MulticastPolicy("in_fabric",
                                                MulticastTable(members)),
                     routing=jad.AdaptiveRouting(**pol))
    tf = tfab.Fabric(trt.ring_topology(8), addr=trt.AddressSpec(),
                     mcast=tfab.MulticastPolicy(
                         "in_fabric", trt.MulticastTable(members)),
                     routing=tad.AdaptiveRouting(**pol), device=CPU)
    tres = tf.run(tspec)
    same_run(jf, jf.run(jspec), tf, tres, "multicast")
    assert int(tres.delivered) == tres.injected == 5 * n


def test_batch_refuses_adaptive_and_run_many_loops():
    jspec, tspec = hot_spot(4, 8, 8)
    jf, tf = adaptive_pair(8, epochs=2)
    with pytest.raises(NotImplementedError) as want:
        jf.run_batch([jspec, jspec])
    with pytest.raises(NotImplementedError, match="AdaptiveRouting") as got:
        tf.run_batch([tspec, tspec])
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="AdaptiveRouting"):
        tfab.run_batch([tf, tf], [tspec, tspec])
    res = tf.run_many([tspec, tspec])
    assert tf.last_dispatch == "loop" and len(res) == 2
    tnet.assert_results_equal(res[0], res[1], "run_many")


def test_auto_bound_that_binds_raises(monkeypatch):
    """An epoch whose automatic bound binds is an error, not a silent
    truncation; an explicit bound may truncate."""
    _, tspec = hot_spot(4, 8, 24)
    _, tf = adaptive_pair(8, queues=dict(capacity=24), epochs=2)
    res = tf.run(tspec, max_steps=40)
    assert int(res.delivered) + int(res.drops) < res.injected
    monkeypatch.setattr(tad, "shared_max_steps", lambda *a, **k: 40)
    with pytest.raises(RuntimeError, match="truncated"):
        tf.run(tspec)
