"""The rest of the ``Fabric`` API on ``device="cpu"``: the timed sweeps
(``sweep``, ``sweep_batch``, ``SweepCell``, ``BatchSweepCell``) and the
runner audits (``CompiledFabric.cache_size``, ``batch_cache_size``),
held against the reference package's on the same traffic.

The port's engines run on runners shared by shape bucket across every
fabric of a device (``network.engine_runner``), the counterpart of the
reference's engines cached by shape: ``cache_size()`` counts the
bucket's solo runners as the reference counts jit entries, so it stays
at one over runs of other traffic, sweeps, adaptive epochs and clone
fabrics with other tables.  One difference is kept on purpose and
checked here: the port binds the flow mode and burst bound into a
runner (they select code paths of its step), so a fabric with another
burst bound adds a runner where the reference adds no jit entry.  Each
test that counts starts from an empty cache, so the counts are
absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import adaptive as jad
from repro.core import fabric as jfab
from repro.core import traffic as jtr
from repro.core.router import RoutingTable, ring_topology
from repro_torch import interop
from repro_torch.core import adaptive as tad
from repro_torch.core import fabric as tfab
from repro_torch.core import network as tnet
from repro_torch.core import router as trt

CPU = "cpu"


@pytest.fixture
def fresh_runners(monkeypatch):
    monkeypatch.setattr(tnet, "_RUNNERS", {})


def both(src, t, dest):
    arrs = [np.asarray(a, np.int32) for a in (src, t, dest)]
    return (jtr.TrafficSpec(*map(jnp.asarray, arrs)),
            interop.from_reference(traffic=arrs).traffic)


def poisson(key, n, epc):
    return both(*jtr.poisson(jax.random.PRNGKey(key), n, epc))


# --- sweeps ---------------------------------------------------------------

@pytest.mark.parametrize("engine", ["ring", "pallas"])
@pytest.mark.parametrize("warm", [True, False])
def test_sweep_cells_equal_the_reference(engine, warm, fresh_runners):
    """Timed cells, each equal to the reference's cell, in its bucket;
    every spec of one bucket runs on one runner."""
    pairs = [poisson(k, 4, 16) for k in range(3)]
    jcells = jfab.Fabric(ring_topology(4), engine=engine).sweep(
        [j for j, _ in pairs], warm=warm)
    fab = tfab.Fabric(trt.ring_topology(4), engine=engine, device=CPU)
    cells = fab.sweep([t for _, t in pairs], warm=warm)
    assert len(cells) == 3
    for i, (jc, c) in enumerate(zip(jcells, cells)):
        assert isinstance(c, tfab.SweepCell)
        assert c.us_per_call > 0 and c.bucket == jc.bucket
        tnet.assert_results_equal(c.result, jc.result, f"cell {i}")
        assert int(c.result.delivered) == c.result.injected
    for b in fab.compiled_buckets:
        assert fab._get_compiled(b).cache_size() == 1


def test_sweep_under_adaptive_routing_equals_the_reference(fresh_runners):
    """Each cell a whole epoched run, equal to the reference's, its
    first epoch's bucket warmed under the shared step bound: the epochs
    run on that one runner."""
    pairs = [both(*jtr.hot_spot(jax.random.PRNGKey(k), 8, 24))
             for k in (4, 5)]
    pol = dict(policy="min_backlog", epochs=4, alpha=4.0)
    jcells = jfab.Fabric(ring_topology(8), routing=jad.AdaptiveRouting(**pol),
                         queues=jfab.QueuePolicy(capacity=24)).sweep(
        [j for j, _ in pairs])
    fab = tfab.Fabric(trt.ring_topology(8),
                      routing=tad.AdaptiveRouting(**pol),
                      queues=tfab.QueuePolicy(capacity=24), device=CPU)
    cells = fab.sweep([t for _, t in pairs])
    for i, (jc, c) in enumerate(zip(jcells, cells)):
        tnet.assert_results_equal(c.result, jc.result, f"adaptive cell {i}")
        assert c.bucket == jc.bucket == fab.last_report.buckets[0]
        assert c.us_per_call > 0
    assert not fab.last_report.recompiled
    assert len(tnet._RUNNERS) == 1
    assert fab._get_compiled(cells[0].bucket).cache_size() == 1


@pytest.mark.parametrize("engine", [
    "ring", "pallas", tfab.EngineSpec("pallas", kernel="multistep")],
    ids=["ring", "step", "multistep"])
def test_sweep_batch_equals_the_reference(engine, fresh_runners):
    """One timed batch of eight: each instance equal to the reference's
    sweep_batch instance, the per-instance share of the call, and one
    batch runner, however often the batch is swept."""
    pairs = [poisson(k, 4, 12) for k in range(8)]
    jeng = engine if isinstance(engine, str) else jfab.EngineSpec(
        "pallas", kernel="multistep")
    jcell = jfab.Fabric(ring_topology(4), engine=jeng).sweep_batch(
        [j for j, _ in pairs])
    fab = tfab.Fabric(trt.ring_topology(4), engine=engine, device=CPU)
    for rep in range(2):
        cell = fab.sweep_batch([t for _, t in pairs], warm=rep == 0)
        assert isinstance(cell, tfab.BatchSweepCell)
        assert cell.bucket == jcell.bucket
        assert cell.us_per_instance == pytest.approx(cell.us_per_call / 8)
        for i in range(8):
            tnet.assert_results_equal(cell.result.instance(i),
                                      jcell.result.instance(i),
                                      f"batch {rep}/{i}")
        assert tfab.batch_cache_size(cell.bucket, device=CPU) == 1
    assert jfab.batch_cache_size(jcell.bucket) >= 1
    # another batch size is another runner
    fab.run_batch([t for _, t in pairs[:4]])
    assert tfab.batch_cache_size(cell.bucket, device=CPU) == 2


def test_batch_cache_size_needs_one_device():
    bucket = ("ring",) + (0,) * 9
    with pytest.raises(NotImplementedError, match="queue C"):
        tfab.batch_cache_size(bucket, 2, device=CPU)
    assert tfab.batch_cache_size(bucket, device=CPU) == 0


# --- cache_size: flat over runs, clones and epochs ------------------------

@pytest.mark.parametrize("engine", ["ring", "reference", "pallas"])
def test_cache_size_flat_over_runs(engine, fresh_runners):
    """After a warm compile the bucket has one runner; runs of other
    traffic keep it at one, as the reference's jit cache stays flat.  A
    fabric of the same bucket with another burst bound adds a runner in
    the port (the bound selects its step's code), none in the
    reference.  The slot engines key their bucket on the step bound, so
    their runs here share an explicit one."""
    jspecs = [poisson(k, 4, 16) for k in (1, 2)]
    ms = None if engine == "ring" else 800
    jf = jfab.Fabric(ring_topology(4), engine=engine)
    fab = tfab.Fabric(trt.ring_topology(4), engine=engine, device=CPU)
    jcf = jf.compile(jspecs[0][0], max_steps=ms)
    cf = fab.compile(jspecs[0][1], max_steps=ms)
    assert cf.bucket == jcf.bucket and cf.cache_size() == 1
    n0 = jcf.cache_size()
    for jspec, tspec in jspecs:
        tnet.assert_results_equal(cf.run(tspec, max_steps=ms),
                                  jcf.run(jspec, max_steps=ms), engine)
    assert cf.cache_size() == 1 and jcf.cache_size() == n0
    other = tfab.Fabric(trt.ring_topology(4), engine=engine, device=CPU)
    other.run(jspecs[0][1], max_steps=ms)
    assert cf.cache_size() == 1
    if engine == "ring":
        tfab.Fabric(trt.ring_topology(4), device=CPU,
                    queues=tfab.QueuePolicy(max_burst=3)).run(jspecs[0][1])
        jfab.Fabric(ring_topology(4),
                    queues=jfab.QueuePolicy(max_burst=3)).run(jspecs[0][0])
        assert cf.cache_size() == 2 and jcf.cache_size() == n0


@pytest.mark.parametrize("engine", ["ring", "pallas"])
def test_clone_fabric_shares_the_runner(engine, fresh_runners):
    """``_with_routing`` (the adaptive loop's per-epoch clone) with
    other tables: same device, same bucket, same runner, and the run of
    a fresh fabric on those tables — and the reference's.  The slot
    engine's bucket keys the step bound, which the adaptive loop shares
    across epochs; so do the runs here."""
    jspec, tspec = both(*jtr.hot_spot(jax.random.PRNGKey(4), 8, 16))
    ms = None if engine == "ring" else 600
    fab = tfab.Fabric(trt.ring_topology(8), engine=engine, device=CPU,
                      queues=tfab.QueuePolicy(capacity=24))
    cf = fab.compile(tspec, max_steps=ms)
    cost = np.full(8, 1024, np.int64)
    cost[0] = 5000
    table = trt.RoutingTable.build_weighted(trt.ring_topology(8), cost)
    clone = fab._with_routing(table)
    assert clone.device == fab.device
    got = clone.run(tspec, max_steps=ms)
    assert clone._plan(tspec, ms).bucket == cf.bucket
    assert len(tnet._RUNNERS) == 1 and cf.cache_size() == 1
    fresh = tfab.Fabric(trt.ring_topology(8), routing=table, engine=engine,
                        queues=tfab.QueuePolicy(capacity=24), device=CPU)
    tnet.assert_results_equal(got, fresh.run(tspec, max_steps=ms),
                              "clone vs fresh")
    jtable = RoutingTable.build_weighted(ring_topology(8), cost)
    want = jfab.Fabric(ring_topology(8), routing=jtable, engine=engine,
                       queues=jfab.QueuePolicy(capacity=24)).run(
        jspec, max_steps=ms)
    tnet.assert_results_equal(got, want, "clone vs reference")
    tnet.assert_results_equal(
        fab.run(tspec, max_steps=ms),
        jfab.Fabric(ring_topology(8), engine=engine,
                    queues=jfab.QueuePolicy(capacity=24)).run(
            jspec, max_steps=ms), "the original after its clone")


def test_graph_reports_the_shared_runner(fresh_runners):
    """On the CPU no graph is captured; ``graph`` reports the runner's
    last run and its capture count."""
    _, tspec = poisson(3, 4, 16)
    cf = tfab.Fabric(trt.ring_topology(4), device=CPU).compile(tspec)
    cf.run(tspec)
    g = cf.graph
    assert g["captures"] == 0 and not g["captured"] and g["steps"] > 0
    cf2 = tfab.Fabric(trt.ring_topology(4), engine="pallas",
                      device=CPU).compile(tspec)
    assert cf2.graph is None          # a CPU warm-up runs nothing
    cf2.run(tspec)
    g = cf2.graph
    assert g["captures"] == 0 and not g["captured"]
    assert g["head"] + g["replays"] * g["graph_steps"] + g["tail"] == \
        cf2.bucket[4]
    assert tfab.Fabric(trt.ring_topology(4), engine="reference",
                       device=CPU).compile(tspec).graph is None
