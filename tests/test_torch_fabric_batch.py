"""Batched fabric runs (``Fabric.run_batch`` / module ``run_batch`` /
``Fabric.run_many``) on ``device="cpu"``, on all four engines: instance
i of a batch equals the solo run of its spec, field for field, and the
reference package's ``run_batch`` instance i.

Every engine runs a batch as one step loop with the whole batch in each
step (the per-step kernel engine's queue step on the batch's (B·Q, C)
rows with instance-offset queue ids, the multi-step kernel one launch
per chunk for all instances, the ring engine until every instance has
drained); here the kernels' plain versions run.  Traffic comes from the
reference's generators (by JAX key) or numpy by seed.  Also: the batch
roll-ups, the refusals, ``run_many``'s dispatch, the port's
``traffic.monte_carlo`` contract and ``telemetry.link_load_batch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import network as jnet
from repro.core import telemetry as jtm
from repro.core import traffic as jtr
from repro.core.link import PAPER_TIMING, SERIAL_LVDS_TIMING
from repro.core.link import per_link_timing as j_per_link_timing
from repro.core.router import AddressSpec, MulticastTable, ring_topology
from repro_torch import interop
from repro_torch.core import fabric as tfab
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import router as trt
from repro_torch.core import telemetry as ttm
from repro_torch.core import traffic as ttr
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"

#: the four engines: name -> (reference EngineSpec, port EngineSpec)
ENGINES = {
    "ring": ("ring", "ring"),
    "reference": ("reference", "reference"),
    "pallas": ("pallas", "pallas"),
    "multistep": (jfab.EngineSpec("pallas", kernel="multistep",
                                  chunk_size=32),
                  tfab.EngineSpec("pallas", kernel="multistep",
                                  chunk_size=32)),
}


def _specs(gen, keys, n, epc):
    """Reference specs from ``gen(PRNGKey(k), n, epc)`` and the port's
    from the same arrays."""
    js = [gen(jax.random.PRNGKey(k), n, epc) for k in keys]
    ts = [interop.from_reference(
        traffic=[np.asarray(a) for a in s]).traffic for s in js]
    return js, ts


def _mixed_timing(ref: bool, n_links, slow=(0,)):
    cls = [0] * n_links
    for l in slow:
        cls[l] = 1
    if ref:
        return j_per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING], cls)
    return tl.per_link_timing([tl.PAPER_TIMING, tl.SERIAL_LVDS_TIMING], cls)


def check_batch(tbatch, solo, jbatch=None, ctx=""):
    """Every instance equals its solo run and the reference batch's."""
    assert tbatch.n_instances == len(solo)
    got = interop.batch_result_to_numpy(tbatch)
    for i, want in enumerate(solo):
        tnet.assert_results_equal(want, tbatch.instance(i), f"{ctx}/{i}")
        if jbatch is not None:
            jnet.assert_results_equal(jbatch.instance(i), got.instance(i),
                                      f"{ctx}/{i} vs reference")


class TestRunBatch:

    @pytest.mark.parametrize("engine", sorted(ENGINES))
    def test_batch_matches_solo_every_engine(self, engine):
        jeng, teng = ENGINES[engine]
        js, ts = _specs(jtr.poisson, range(3), 8, 8)
        fab = tfab.Fabric(trt.ring_topology(8), engine=teng, device=CPU)
        batch = fab.run_batch(ts)
        # slot plans of one batch share the largest default step bound
        steps = max(fab._plan(s, None).max_steps for s in ts)
        solo = tfab.Fabric(trt.ring_topology(8), engine=teng, device=CPU)
        jb = jfab.Fabric(ring_topology(8), engine=jeng).run_batch(js)
        check_batch(batch, [solo.run(s, max_steps=None if engine == "ring"
                                     else steps) for s in ts], jb, engine)
        assert batch.log_del.device == torch.device(CPU)
        assert batch.delivered.dtype == torch.int32

    @pytest.mark.parametrize("engine", ["ring", "pallas", "multistep"])
    def test_hetero_timing_batch(self, engine):
        jeng, teng = ENGINES[engine]
        js, ts = _specs(jtr.poisson, (2, 5, 9), 6, 12)
        kw = dict(queues=tfab.QueuePolicy(max_burst=1))
        fab = tfab.Fabric(trt.ring_topology(6), engine=teng, device=CPU,
                          timing=_mixed_timing(False, 6, (0, 3)), **kw)
        batch = fab.run_batch(ts, max_steps=400)
        jb = jfab.Fabric(ring_topology(6), engine=jeng,
                         timing=_mixed_timing(True, 6, (0, 3)),
                         queues=jfab.QueuePolicy(max_burst=1)).run_batch(
                             js, max_steps=400)
        check_batch(batch, [fab.run(s, max_steps=400) for s in ts], jb,
                    engine)

    @pytest.mark.parametrize("engine", ["ring", "pallas"])
    def test_credit_flow_batch(self, engine):
        """Lossless credit flow under a batch: no drops per instance."""
        jeng, teng = ENGINES[engine]
        js, ts = _specs(jtr.hot_spot, range(3), 8, 12)
        q = dict(capacity=6, flow="credit")
        fab = tfab.Fabric(trt.ring_topology(8), engine=teng, device=CPU,
                          queues=tfab.QueuePolicy(**q))
        batch = fab.run_batch(ts, max_steps=600)
        jb = jfab.Fabric(ring_topology(8), engine=jeng,
                         queues=jfab.QueuePolicy(**q)).run_batch(
                             js, max_steps=600)
        check_batch(batch, [fab.run(s, max_steps=600) for s in ts], jb,
                    engine)
        assert (batch.drops == 0).all()
        assert (batch.telemetry.stall_steps.sum(dim=(1, 2)) > 0).any()

    @pytest.mark.parametrize("engine", ["ring", "multistep"])
    def test_in_fabric_multicast_batch(self, engine):
        """Tagged events replicate inside a batch (per-instance
        replication tables)."""
        jeng, teng = ENGINES[engine]
        members = np.zeros((1, 8), bool)
        members[0, 2:7] = True
        addr = AddressSpec()
        arrays = []
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            n = 16
            src = np.r_[np.zeros(n), np.ones(n // 2)].astype(np.int64)
            t = np.r_[np.sort(rng.integers(0, n * 40, n)),
                      10 + np.arange(n // 2) * 40]
            dest = np.r_[addr.pack_multicast(np.zeros(n, np.int64)),
                         addr.pack(np.full(n // 2, 3, np.int64))]
            order = np.argsort(t, kind="stable")
            arrays.append([np.asarray(a[order], np.int32)
                           for a in (src, t, dest)])
        js = [jtr.TrafficSpec(*map(jnp.asarray, a)) for a in arrays]
        ts = [interop.from_reference(traffic=a).traffic for a in arrays]
        fab = tfab.Fabric(trt.ring_topology(8), engine=teng, device=CPU,
                          addr=trt.AddressSpec(),
                          mcast=tfab.MulticastPolicy(
                              "in_fabric", trt.MulticastTable(members)))
        batch = fab.run_batch(ts, max_steps=500)
        jb = jfab.Fabric(ring_topology(8), engine=jeng, addr=addr,
                         mcast=jfab.MulticastPolicy(
                             "in_fabric", MulticastTable(members))
                         ).run_batch(js, max_steps=500)
        check_batch(batch, [fab.run(s, max_steps=500) for s in ts], jb,
                    engine)
        assert (batch.delivered.numpy() == batch.injected).all()

    @pytest.mark.parametrize("engine", ["ring", "reference", "multistep"])
    def test_cross_fabric_batch(self, engine):
        """One batch of fabrics that differ in timing, queue policy and
        reset polarity (per-instance flow mode, capacity and, on the
        ring, burst bound: run operands, not buckets)."""
        jeng, teng = ENGINES[engine]
        ring = engine == "ring"
        pols = [dict(capacity=6, flow="credit", max_burst=1 if ring else 0),
                dict(capacity=16),
                dict(capacity=6, flow="onoff", xon=2,
                     max_burst=2 if ring else 0,
                     initial_tx=np.array([0, 1, 0, 1, 1, 0]))]
        slow = [(), (0, 3), (2,)]
        js, ts = _specs(jtr.hot_spot, (7, 8, 9), 6, 12)
        tfabs = [tfab.Fabric(trt.ring_topology(6), engine=teng, device=CPU,
                             timing=_mixed_timing(False, 6, sl),
                             queues=tfab.QueuePolicy(**p))
                 for p, sl in zip(pols, slow)]
        jfabs = [jfab.Fabric(ring_topology(6), engine=jeng,
                             timing=_mixed_timing(True, 6, sl),
                             queues=jfab.QueuePolicy(**p))
                 for p, sl in zip(pols, slow)]
        batch = tfab.run_batch(tfabs, ts, max_steps=500)
        jb = jfab.run_batch(jfabs, js, max_steps=500)
        check_batch(batch, [f.run(s, max_steps=500)
                            for f, s in zip(tfabs, ts)], jb, engine)
        assert int(batch.drops[1]) > 0
        assert int(batch.drops[0]) == int(batch.drops[2]) == 0

    def test_conservation_and_rollups(self):
        js, ts = _specs(jtr.hot_spot, range(4), 8, 12)
        q = dict(capacity=20)
        batch = tfab.Fabric(trt.ring_topology(8), device=CPU,
                            queues=tfab.QueuePolicy(**q)).run_batch(ts)
        jb = jfab.Fabric(ring_topology(8),
                         queues=jfab.QueuePolicy(**q)).run_batch(js)
        assert (batch.drops > 0).any()
        for r in batch.results():
            assert int(r.delivered) + int(r.drops) == r.injected
        thr = tnet.batch_throughput_mev_s(batch)
        assert thr.shape == (4,) and thr.dtype == torch.float32
        np.testing.assert_allclose(
            thr.numpy(), np.asarray(jnet.batch_throughput_mev_s(jb)),
            rtol=1e-6)
        assert tnet.batch_latency_stats(batch) == \
            jnet.batch_latency_stats(jb)
        # the reference's batch carried over into the port's type
        back = interop.batch_result_from_reference(jb)
        for i in range(4):
            tnet.assert_results_equal(back.instance(i), batch.instance(i),
                                      f"from reference/{i}")


class TestRefusals:

    def test_mixed_bucket_refused(self):
        fab = tfab.Fabric(trt.ring_topology(4), engine="reference",
                          device=CPU)
        _, (a, b) = _specs(jtr.poisson, (1, 1), 4, 8)
        b = b._replace(src=b.src[:16], t=b.t[:16], dest=b.dest[:16])
        with pytest.raises(ValueError, match="ONE shape bucket"):
            fab.run_batch([a, b])

    def test_empty_refused(self):
        with pytest.raises(ValueError, match="at least one"):
            tfab.Fabric(trt.ring_topology(4), device=CPU).run_batch([])

    def test_fabric_spec_count_mismatch(self):
        _, ts = _specs(jtr.poisson, (1, 2), 4, 8)
        with pytest.raises(ValueError, match="1:1"):
            tfab.run_batch([tfab.Fabric(trt.ring_topology(4), device=CPU)],
                           ts)

    def test_devices(self):
        _, ts = _specs(jtr.poisson, (1, 2), 4, 8)
        fab = tfab.Fabric(trt.ring_topology(4), device=CPU)
        a = fab.run_batch(ts)
        for devices in (1, "all"):
            b = fab.run_batch(ts, devices=devices)
            for i in range(2):
                tnet.assert_results_equal(a.instance(i), b.instance(i),
                                          f"devices={devices}/{i}")
        with pytest.raises(NotImplementedError, match="queue C"):
            fab.run_batch(ts, devices=2)
        with pytest.raises(ValueError, match=">= 1"):
            fab.run_batch(ts, devices=0)

    def test_mixed_link_counts_and_devices_refused(self):
        _, ts = _specs(jtr.poisson, (1, 2), 4, 8)
        with pytest.raises(ValueError, match="link count"):
            tfab.run_batch([tfab.Fabric(trt.ring_topology(4), device=CPU),
                            tfab.Fabric(trt.line_topology(4), device=CPU)],
                           ts)


class TestRunMany:

    def test_same_bucket_dispatches_batch(self):
        js, ts = _specs(jtr.poisson, range(3), 4, 16)
        fab = tfab.Fabric(trt.ring_topology(4), device=CPU)
        results = fab.run_many(ts)
        assert fab.last_dispatch == "batch"
        for s, j, r in zip(ts, js, results):
            tnet.assert_results_equal(
                tnet.simulate_fabric(trt.ring_topology(4), s, device=CPU),
                r, "many-batch")
            jnet.assert_results_equal(
                jnet.simulate_fabric(ring_topology(4), j),
                interop.result_to_numpy(r), "many-batch vs reference")

    def test_single_spec_loops(self):
        _, ts = _specs(jtr.poisson, (1,), 4, 16)
        fab = tfab.Fabric(trt.ring_topology(4), device=CPU)
        fab.run_many(ts)
        assert fab.last_dispatch == "loop"

    def test_mixed_buckets_loop(self):
        _, (a, b) = _specs(jtr.poisson, (1, 1), 4, 8)
        b = b._replace(src=b.src[:20], t=b.t[:20], dest=b.dest[:20])
        fab = tfab.Fabric(trt.ring_topology(4), engine="reference",
                          device=CPU)
        results = fab.run_many([a, b])
        assert fab.last_dispatch == "loop"
        for s, r in zip((a, b), results):
            tnet.assert_results_equal(
                tnet.simulate_fabric(trt.ring_topology(4), s, device=CPU,
                                     engine="reference"), r, "many-loop")


class TestMonteCarloTraffic:

    @pytest.mark.parametrize("pattern", sorted(ttr.PATTERNS))
    def test_instances_match_solo_child_generators(self, pattern):
        """Instance i is ``PATTERNS[pattern]`` drawn solo from a child
        generator seeded with the i-th of ``batch`` seeds taken from the
        caller's generator."""
        specs = ttr.monte_carlo(pattern, torch.Generator().manual_seed(11),
                                4, 8, 16)
        seeds = torch.randint(0, ttr.MC_SEED_BOUND, (4,),
                              generator=torch.Generator().manual_seed(11),
                              dtype=torch.int64).tolist()
        assert len(specs) == 4 and len(set(seeds)) == 4
        for s, seed in zip(specs, seeds):
            solo = ttr.PATTERNS[pattern](torch.Generator().manual_seed(seed),
                                         8, 16)
            for f in ttr.TrafficSpec._fields:
                assert torch.equal(getattr(s, f), getattr(solo, f)), f
            assert s.src.dtype == torch.int32
        # one bucket: the batch runs as one computation
        fab = tfab.Fabric(trt.ring_topology(8), device=CPU)
        assert len({fab._plan(s, None).bucket for s in specs}) == 1
        if pattern != "ping_pong":          # ping_pong takes no draws
            assert not torch.equal(specs[0].t, specs[1].t)

    def test_prefix_does_not_depend_on_batch(self):
        a = ttr.monte_carlo("poisson", torch.Generator().manual_seed(3), 2,
                            4, 8)
        b = ttr.monte_carlo("poisson", torch.Generator().manual_seed(3), 5,
                            4, 8)
        for x, y in zip(a, b[:2]):
            assert all(torch.equal(u, v) for u, v in zip(x, y))

    def test_validation(self):
        g = torch.Generator().manual_seed(0)
        with pytest.raises(ValueError, match="unknown pattern"):
            ttr.monte_carlo("nope", g, 2, 4, 8)
        with pytest.raises(ValueError, match="batch"):
            ttr.monte_carlo("poisson", g, 0, 4, 8)


class TestTelemetryBatch:

    def test_link_load_batch_matches_solo_and_reference(self):
        js, ts = _specs(jtr.hot_spot, range(3), 8, 12)
        q = dict(capacity=20)
        fab = tfab.Fabric(trt.ring_topology(8), device=CPU,
                          queues=tfab.QueuePolicy(**q))
        loads = ttm.link_load_batch(fab.run_batch(ts))
        jloads = jtm.link_load_batch(jfab.Fabric(
            ring_topology(8), queues=jfab.QueuePolicy(**q)).run_batch(js))
        assert len(loads) == 3
        for i, s in enumerate(ts):
            solo = ttm.link_load(fab.run(s))
            for f in ttm.LinkLoad._fields:
                np.testing.assert_array_equal(getattr(loads[i], f),
                                              getattr(solo, f))
                np.testing.assert_array_equal(getattr(loads[i], f),
                                              np.asarray(getattr(jloads[i],
                                                                 f)))
