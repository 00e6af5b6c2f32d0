"""The CUDA kernels on the card, against their plain PyTorch versions
(the per-step pair, on misaligned planes and sentinel rows too, and on
a batch's (B·Q, C) rows with instance-offset queue ids; the per-step
engine replayed from its captured CUDA graph against the eager
engine="reference"; the ring engine replaying its chunk's graph, run
after run, against its CPU run; batches of every engine against their
solo runs; the multi-step kernel on packed carries of the chip_smoke
cells, solo, as B = 3 instances and as B = 8 against eight B = 1
launches,
the LIF update on the
shared LIF cases, the AER encoder and decoder on the shared AER
cases, full width and 8-peer decode included, and the selective scan on
the shared scan cases, falcon-mamba-7b's prefill shape included, and
the scan's backward kernel and autograd Function on the same cases), and
the co-simulation, SNN, AER all-reduce, LM serve and training paths
launching them (the data-parallel ``aer_topk`` step in a world of one
among them).

Marked ``gpu``: each test skips where there is no CUDA card (the kernels
have no CPU mode).  This file imports no JAX, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import network as net
from repro_torch.core.fabric import EngineSpec, Fabric, QueuePolicy
from repro_torch.core.router import ring_topology
from repro_torch.core.traffic import hot_spot
from repro_torch import cosim
from repro_torch.core.router import AddressSpec
from repro_torch.core import sparse_collectives as sc
from repro_torch.kernels import aer_decode as adk
from repro_torch.kernels import aer_encode as aek
from repro_torch.kernels import fabric_queue as fq
from repro_torch.kernels import lif_step as lk
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ssk
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import snn
from repro_torch.models.model import LM, build_model

from _torch_cases import (AER_ROUTE_CASES, COMBINE_ROUTINGS,
                          LIF_CARD_SHAPES, LIF_PARAMS,
                          MS_BATCH, MS_STEPS, aer_arrays, aer_mismatches,
                          aer_offset_copy, aer_route_arrays, aer_specs,
                          carry_err, clone, combine_case, lif_cases,
                          lif_double_roundings, lif_on_card,
                          multistep_cases, multistep_operands, planes,
                          offset_tensor, run_schedule, scan_arrays,
                          scan_bwd_tol, scan_case, scan_cotangents,
                          scan_errors, scan_specs,
                          sentinel_scan_case, STEP_OFFSETS,
                          STEP_SHAPES, update_case)

SHAPES = [(4, 7), (2, 5), (16, 96), (32, 768), (224, 3072)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _equal(want, got):
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert torch.equal(w, g.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", STEP_SHAPES)
def test_step_kernel_matches_plain(cuda, nq, nc):
    q, qd, t = scan_case(np.random.default_rng(nq + nc), nq, nc)
    _equal(ref.fabric_queue_scan(_t(q), _t(qd), _t(t)),
           fq.fabric_queue_step(_t(q, cuda), _t(qd, cuda), _t(t, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", [(4, 3), (5, 33), (32, 768)])
@pytest.mark.parametrize("off_q,off_d", STEP_OFFSETS)
def test_step_kernel_misaligned_rows_match_plain(cuda, nq, nc, off_q,
                                                 off_d):
    """Planes that start 1-3 words past a 16-byte boundary: a scalar
    head before the vectors, or no vectors where the two planes' phases
    differ."""
    q, qd, t = scan_case(np.random.default_rng(nq + nc + off_q), nq, nc)
    qc, dc = offset_tensor(q, cuda, off_q), offset_tensor(qd, cuda, off_d)
    assert (qc.data_ptr() % 16, dc.data_ptr() % 16) == (4 * off_q,
                                                        4 * off_d)
    _equal(ref.fabric_queue_scan(_t(q), _t(qd), _t(t)),
           fq.fabric_queue_step(qc, dc, _t(t, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", [(8, 1), (8, 33), (8, 768)])
def test_step_kernel_sentinel_rows_match_plain(cuda, nq, nc):
    """Empty rows and values next to BIG_NS under clocks at and past
    BIG_NS (empty slots count as released there)."""
    q, qd, t = sentinel_scan_case(nq, nc)
    _equal(ref.fabric_queue_scan(_t(q), _t(qd), _t(t)),
           fq.fabric_queue_step(_t(q, cuda), _t(qd, cuda), _t(t, cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nc", SHAPES)
@pytest.mark.parametrize("k", [1, 4])
def test_update_kernel_matches_plain(cuda, nq, nc, k):
    rng = np.random.default_rng(nq * 3 + nc + k)
    pl = planes(rng, nq, nc)
    lanes = update_case(rng, nq, nc, k)
    want = ref.fabric_queue_update(*map(_t, pl), *map(_t, lanes))
    on_card = [_t(p, cuda) for p in pl]
    got = fq.fabric_queue_update(*on_card,
                                 *(_t(a, cuda) for a in lanes))
    assert all(g is p for g, p in zip(got, on_card))   # in place
    _equal(want, got)


@pytest.mark.gpu
def test_wrappers_validate_operands(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    t = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fq.fabric_queue_step(q.long(), q, t)
    with pytest.raises(ValueError, match="contiguous"):
        fq.fabric_queue_step(q.t().contiguous().t(), q, t)
    with pytest.raises(ValueError):
        fq.fabric_queue_step(q, q, t[:3])


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    """A small credit-flow run: the kernel engine on the card against
    the plain engine on the CPU, and 2·max_steps launches."""
    spec = hot_spot(torch.Generator().manual_seed(0), 6, 12)
    kw = dict(queues=QueuePolicy(capacity=5, flow="credit"))
    cf = Fabric(ring_topology(6), device=cuda, engine="pallas",
                **kw).compile(spec)
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    res = cf.run(spec)
    torch.cuda.synchronize()
    steps = cf.bucket[4]
    assert fq.fabric_queue_step.launches == steps
    assert fq.fabric_queue_update.launches == steps
    cpu = Fabric(ring_topology(6), device="cpu", engine="reference",
                 **kw).run(spec)
    net.assert_results_equal(res, cpu, "card vs cpu")


# --- the per-step engine replayed from a captured CUDA graph -----------

G = net.GRAPH_STEPS


def _graph_cells():
    from repro_torch.core.fabric import MulticastPolicy
    from repro_torch.core.router import MulticastTable, mesh2d_topology
    from _torch_cases import (anchor_arrays, hot_spot_arrays,
                              mesh_multicast_case, spec_of)
    members, arrays = mesh_multicast_case(8 * 6)
    return {
        "anchor": (dict(topo=ring_topology(2),
                        queues=QueuePolicy(max_burst=1)),
                   spec_of(*anchor_arrays(48))),
        "ring16_credit": (dict(topo=ring_topology(16),
                               queues=QueuePolicy(capacity=6,
                                                  flow="credit")),
                          spec_of(*hot_spot_arrays(16, 8, 300.0, 0.65,
                                                   seed=2))),
        "mesh2x4_multicast": (dict(topo=mesh2d_topology(2, 4),
                                   addr=AddressSpec(),
                                   mcast=MulticastPolicy(
                                       "in_fabric",
                                       MulticastTable(members))),
                              spec_of(*arrays)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["anchor", "ring16_credit",
                                  "mesh2x4_multicast"])
@pytest.mark.parametrize("steps", [None, 1, 2, G + 1, G + 2, G + 3,
                                   2 * G + 1, 2 * G + 2, 3 * G + 5])
def test_graph_run_matches_eager(cuda, cell, steps):
    """The captured per-step engine against engine="reference" (the
    eager loop of the plain step) on the card, field for field, with
    exactly max_steps launches of each wrapper."""
    kw, spec = _graph_cells()[cell]
    cf = Fabric(**kw, device=cuda, engine="pallas").compile(
        spec, max_steps=steps)
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    res = cf.run(spec, max_steps=steps)
    torch.cuda.synchronize()
    n = cf.bucket[4]
    head, replays, tail = net._graph_plan(n, G, net.GRAPH_MIN_REPLAYS)
    graph = cf.graph
    assert graph["replays"] == replays and graph["tail"] == tail
    # compile() captured the bucket's graph (or found it captured)
    assert not graph["captured"] and graph["captures"] == int(replays > 0)
    assert (replays > 0) == (graph.get("replay_device_s", 0) > 0)
    assert fq.fabric_queue_step.launches == n
    assert fq.fabric_queue_update.launches == n
    want = Fabric(**kw, device=cuda, engine="reference").run(
        spec, max_steps=steps)
    net.assert_results_equal(res, want, f"{cell} at {steps} steps")


# --- batches: the per-step pair on the batch's rows, the ring engine ----

#: the batch phase's instances: ring-16 hot spots, seeds 2..9
BATCH_SEEDS = tuple(range(2, 10))


@pytest.mark.gpu
def test_step_kernel_on_batched_rows_matches_plain(cuda):
    """B1 on the (B·Q, C) rows of B = 8 instances' planes (the batched
    per-step engine's one launch) against the plain scan of each
    instance's own (Q, C) rows."""
    rng = np.random.default_rng(8)
    cases = [scan_case(rng, 32, 768) for _ in range(8)]
    q, qd, t = (np.concatenate([c[i] for c in cases]) for i in range(3))
    got = fq.fabric_queue_step(_t(q, cuda), _t(qd, cuda), _t(t, cuda))
    torch.cuda.synchronize()
    for b, (qb, qdb, tb) in enumerate(cases):
        want = ref.fabric_queue_scan(_t(qb), _t(qdb), _t(tb))
        for w, g in zip(want, got):
            assert torch.equal(w, g[32 * b:32 * (b + 1)].cpu()), b


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_update_kernel_instance_offsets_match_solo(cuda, k):
    """B2 on the flattened (B·Q, C) planes with queue ids offset by b·Q
    and skipped lanes at B·Q (the kernel's own skip rule, id >= rows)
    against B solo calls of the plain update."""
    rng = np.random.default_rng(k)
    B, nq, nc = 4, 32, 768
    pls = [planes(rng, nq, nc) for _ in range(B)]
    lanes = [update_case(rng, nq, nc, k) for _ in range(B)]
    got = [_t(np.concatenate([p[i] for p in pls]), cuda) for i in range(3)]
    glob = []
    for i in range(len(lanes[0])):
        parts = []
        for b, ln in enumerate(lanes):
            a = np.asarray(ln[i], np.int64)
            if i in (0, 2):                       # pop_q, app_q
                a = np.where(a < nq, a + b * nq, B * nq)
            parts.append(a)
        glob.append(_t(np.concatenate(parts), cuda))
    fq.fabric_queue_update(*got, *glob)
    torch.cuda.synchronize()
    for b in range(B):
        want = ref.fabric_queue_update(*map(_t, pls[b]), *map(_t, lanes[b]))
        for w, g in zip(want, got):
            assert torch.equal(w, g[nq * b:nq * (b + 1)].cpu()), b


@pytest.mark.gpu
def test_multistep_b8_matches_eight_solo_launches(cuda):
    """B3 at B = 8 (one block an instance) against eight B = 1 launches
    of the same carries, chunk 128 over MS_STEPS steps."""
    from _torch_cases import hot_spot_arrays
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    ops8 = [multistep_operands(kw, hot_spot_arrays(16, 48, 300.0, 0.65,
                                                   seed=s), MS_STEPS, cuda)
            for s in BATCH_SEEDS]
    carry = tuple(torch.stack([o[0][j] for o in ops8]) for j in range(7))
    consts = tuple(torch.stack([o[1][j] for o in ops8]) for j in range(6))
    got = _ms_kernel(carry, consts, 128, 0)
    for i, (c, k, _, plan) in enumerate(ops8):
        one = _ms_kernel(tuple(t[None] for t in c),
                         tuple(t[None] for t in k), 128, 0)
        torch.cuda.synchronize()
        assert carry_err(tuple(t[0] for t in one),
                         tuple(g[i] for g in got), plan.E) == 0, i


def _ring16(seed=2, cap=64):
    from _torch_cases import hot_spot_arrays, spec_of
    return (dict(topo=ring_topology(16),
                 queues=QueuePolicy(capacity=cap, flow="credit")),
            spec_of(*hot_spot_arrays(16, 48, 300.0, 0.65, seed=seed)))


@pytest.mark.gpu
def test_ring_engine_on_card_matches_cpu_and_reuses_its_graph(cuda):
    """Ring-16 under credit flow: the ring engine on the card (its chunk
    replayed from the CUDA graph that compile() captured) against its
    CPU run; a second run of the bucket, on other traffic, replays the
    same graph without capturing again; no kernel of the port runs."""
    kw, spec = _ring16()
    cf = Fabric(**kw, device=cuda).compile(spec)
    assert cf.bucket[0] == "ring" and cf.graph["captures"] == 1
    for w in (fq.fabric_queue_step, fq.fabric_queue_update,
              fq.fabric_queue_multistep):
        w.launches = 0
    for seed in (2, 3):
        kw_s, spec_s = _ring16(seed)
        res = cf.fabric.run(spec_s)
        torch.cuda.synchronize()
        g = cf.graph
        assert not g["captured"] and g["captures"] == 1
        assert g["replays"] > 0 and g["replay_device_s"] > 0
        cpu = Fabric(**kw_s, device="cpu").run(spec_s)
        net.assert_results_equal(res, cpu, f"ring card vs cpu, seed {seed}")
        assert int(res.delivered) == res.injected
    assert fq.fabric_queue_step.launches == fq.fabric_queue_update.launches \
        == fq.fabric_queue_multistep.launches == 0


@pytest.mark.gpu
def test_capture_survives_dropped_fabrics(cuda, monkeypatch):
    """Garbage freed by Python's collector while a graph is being
    captured must not invalidate that capture (a graph freed mid-capture
    did, when each fabric kept its own).  Dropped fabrics and their
    runners pile up with the collector off, then it runs at nearly every
    allocation while fresh runners (a fresh runner cache) capture."""
    import gc
    kw, spec = _ring16()
    want = Fabric(**kw, device="cpu").run(spec, max_steps=400)
    threshold = gc.get_threshold()
    monkeypatch.setattr(net, "_RUNNERS", {})
    gc.disable()
    try:
        for eng in ("ring", "pallas"):
            Fabric(**kw, device=cuda, engine=eng).run(spec, max_steps=400)
        monkeypatch.setattr(net, "_RUNNERS", {})
        gc.set_threshold(1)
        gc.enable()
        for eng in ("ring", "pallas"):
            got = Fabric(**kw, device=cuda, engine=eng).run(spec,
                                                            max_steps=400)
            torch.cuda.synchronize()
            net.assert_results_equal(got, want, eng)
    finally:
        gc.set_threshold(*threshold)
        gc.enable()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ring", "pallas",
                                    EngineSpec("pallas", kernel="multistep")])
def test_batch_on_card_matches_solo(cuda, engine):
    """Four ring-16 instances through run_batch on the card against their
    solo CPU runs; the per-step engine launches B1 and B2 once a step
    for the whole batch, the multi-step engine B3 once a chunk."""
    kw, _ = _ring16()
    specs = [_ring16(s)[1] for s in BATCH_SEEDS[:4]]
    fab = Fabric(**kw, device=cuda, engine=engine)
    for w in (fq.fabric_queue_step, fq.fabric_queue_update,
              fq.fabric_queue_multistep):
        w.launches = 0
    batch = fab.run_batch(specs, max_steps=700)
    torch.cuda.synchronize()
    cpu = Fabric(**kw, device="cpu", engine=engine)
    for i, s in enumerate(specs):
        net.assert_results_equal(batch.instance(i),
                                 cpu.run(s, max_steps=700), f"batch/{i}")
    kern = fab.engine.kernel if fab.engine.resolved == "pallas" else None
    assert fq.fabric_queue_step.launches == (700 if kern == "step" else 0)
    assert fq.fabric_queue_update.launches == (700 if kern == "step"
                                               else 0)
    assert fq.fabric_queue_multistep.launches == (
        -(-700 // 128) if kern == "multistep" else 0)


# --- runners shared by bucket: clones, reuse, quarantine ----------------

@pytest.mark.gpu
def test_clone_fabric_reuses_the_ring_graph(cuda):
    """The adaptive loop's per-epoch clone (``_with_routing``, other
    tables) runs on the ring runner its original warmed: no capture,
    ``captures`` stays 1, and the run equals a fresh fabric's on the CPU
    with the same tables."""
    from repro_torch.core.router import RoutingTable
    kw, spec = _ring16()
    fab = Fabric(**kw, device=cuda)
    cf = fab.compile(spec)
    assert cf.graph["captures"] == 1
    cost = np.full(16, 1024, np.int64)
    cost[:3] = 4096
    table = RoutingTable.build_weighted(ring_topology(16), cost)
    clone = fab._with_routing(table)
    assert clone.device == fab.device
    res = clone.run(spec)
    torch.cuda.synchronize()
    g = clone._get_compiled(cf.bucket).graph
    assert not g["captured"] and g["captures"] == 1 and g["replays"] > 0
    assert clone._get_compiled(cf.bucket).cache_size() == cf.cache_size()
    want = Fabric(**kw, routing=table, device="cpu").run(spec)
    net.assert_results_equal(res, want, "clone on the card vs fresh cpu")


@pytest.mark.gpu
def test_step_graph_reused_across_runs_of_one_bucket(cuda, monkeypatch):
    """The per-step kernel engine's graph, captured once for its bucket,
    replayed by two runs of different traffic (seeds 2 and 3, 200 steps:
    six replays each), each equal bit for bit to the eager
    engine="reference" run on the card."""
    monkeypatch.setattr(net, "_RUNNERS", {})
    kw, _ = _ring16()
    fab = Fabric(**kw, device=cuda, engine="pallas")
    captures = []
    for seed in (2, 3):
        spec = _ring16(seed)[1]
        res = fab.run(spec, max_steps=200)
        torch.cuda.synchronize()
        g = fab._get_compiled(fab._plan(spec, 200).bucket).graph
        captures.append((g["captured"], g["captures"], g["replays"]))
        want = Fabric(**kw, device=cuda, engine="reference").run(
            spec, max_steps=200)
        net.assert_results_equal(res, want, f"seed {seed}")
    assert captures == [(True, 1, 6), (False, 1, 6)]
    assert len(net._RUNNERS) == 2          # the step and plain engines


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ring", "pallas",
                                    EngineSpec("pallas", kernel="multistep")])
def test_quarantined_fabric_matches_reference_on_card(cuda, engine):
    """Ring-4 whose routes (0, 1) and (3, 1) loop: admitted under credit
    flow with those pairs quarantined; clean traffic on each engine
    equals engine="reference" on the card, lossless."""
    from repro_torch.core.fabric import StaticShortestPath
    from repro_torch.core.router import RoutingTable
    from _torch_cases import spec_of

    def bent(topo, rt):
        nl, os_ = rt.next_link.copy(), rt.out_side.copy()
        nl[0, 1], os_[0, 1] = 3, 1
        nl[3, 1], os_[3, 1] = 3, 0
        return RoutingTable(next_link=nl, out_side=os_, hops=rt.hops)

    kw = dict(topo=ring_topology(4), device=cuda,
              routing=StaticShortestPath(table_override=bent),
              queues=QueuePolicy(capacity=8, flow="credit"))
    spec = spec_of([0, 1, 2, 3, 0, 2], [0, 0, 0, 0, 40, 40],
                   [2, 3, 0, 2, 3, 1])
    got = Fabric(**kw, engine=engine).run(spec)
    want = Fabric(**kw, engine="reference").run(spec)
    torch.cuda.synchronize()
    net.assert_results_equal(got, want, f"quarantined ring-4 on {engine}")
    assert int(got.delivered) == got.injected and int(got.drops) == 0
    with pytest.raises(ValueError, match="quarantined"):
        Fabric(**kw, engine=engine).run(spec_of([0], [0], [1]))


# --- the multi-step kernel ----------------------------------------------

MS_CASES = {name: (kw, arrays, chunks)
            for name, kw, arrays, chunks in multistep_cases()}


def _ms_plain(carry, consts, step_fn):
    return run_schedule(
        lambda c, b, ch: ref.fabric_queue_multistep(
            c, consts, b, step_fn=step_fn, chunk=ch, max_steps=MS_STEPS),
        clone(carry), MS_STEPS, 128)


def _ms_kernel(carry, consts, chunk, max_burst):
    return run_schedule(
        lambda c, b, ch: fq.fabric_queue_multistep(
            c, consts, b, chunk=ch, max_steps=MS_STEPS, max_burst=max_burst),
        clone(carry), MS_STEPS, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MS_CASES))
def test_multistep_kernel_matches_plain(cuda, name):
    """Every chunk of the case against one plain run of MS_STEPS steps:
    launches with base > 0, and a max_steps that binds mid-chunk."""
    kw, arrays, chunks = MS_CASES[name]
    carry, consts, step_fn, plan = multistep_operands(kw, arrays, MS_STEPS,
                                                      cuda)
    want = _ms_plain(carry, consts, step_fn)
    for chunk in chunks:
        got = _ms_kernel(carry, consts, chunk, plan.bucket[5])
        torch.cuda.synchronize()
        assert carry_err(want, got, plan.E) == 0, (name, chunk)


@pytest.mark.gpu
def test_multistep_batch_matches_solo(cuda):
    """One launch schedule of B = 3 instances (credit, drop, on/off)
    against the three solo plain runs."""
    ops = [multistep_operands(MS_CASES[n][0], MS_CASES[n][1], MS_STEPS,
                              cuda) for n in MS_BATCH]
    carry = tuple(torch.stack([o[0][j] for o in ops]) for j in range(7))
    consts = tuple(torch.stack([o[1][j] for o in ops]) for j in range(6))
    got = _ms_kernel(carry, consts, 128, ops[0][3].bucket[5])
    torch.cuda.synchronize()
    for i, (c, k, step_fn, plan) in enumerate(ops):
        want = _ms_plain(c, k, step_fn)
        assert carry_err(want, tuple(g[i] for g in got), plan.E) == 0, i


@pytest.mark.gpu
def test_multistep_engine_launches(cuda):
    """ceil(max_steps / chunk) launches, none of the per-step pair, and
    the CPU plain engine's result."""
    spec = hot_spot(torch.Generator().manual_seed(0), 6, 12)
    kw = dict(queues=QueuePolicy(capacity=5, flow="credit"))
    eng = EngineSpec("pallas", kernel="multistep", chunk_size=16)
    cf = Fabric(ring_topology(6), device=cuda, engine=eng,
                **kw).compile(spec)
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    fq.fabric_queue_multistep.launches = 0
    res = cf.run(spec)
    torch.cuda.synchronize()
    steps = cf.bucket[4]
    assert fq.fabric_queue_multistep.launches == -(-steps // 16)
    assert fq.fabric_queue_step.launches == 0
    assert fq.fabric_queue_update.launches == 0
    cpu = Fabric(ring_topology(6), device="cpu", engine="reference",
                 **kw).run(spec)
    net.assert_results_equal(res, cpu, "multistep card vs cpu")


@pytest.mark.gpu
def test_multistep_wrapper_validates_operands(cuda):
    kw, arrays, _ = MS_CASES["anchor"]
    carry, consts, _, _ = multistep_operands(kw, arrays, MS_STEPS, cuda)
    base = torch.zeros(1, dtype=torch.int32, device=cuda)
    call = dict(chunk=4, max_steps=8, max_burst=1)
    with pytest.raises(TypeError, match="int32"):
        fq.fabric_queue_multistep((carry[0].long(),) + carry[1:], consts,
                                  base, **call)
    strided = carry[0].t().contiguous().t()          # (Q, C) = (2, 2048)
    with pytest.raises(ValueError, match="contiguous"):
        fq.fabric_queue_multistep((strided,) + carry[1:], consts, base,
                                  **call)
    with pytest.raises(ValueError, match="is on cpu"):
        fq.fabric_queue_multistep(carry[:6] + (carry[6].cpu(),), consts,
                                  base, **call)
    with pytest.raises(ValueError, match="on cpu"):
        fq.fabric_queue_multistep(tuple(t.cpu() for t in carry),
                                  tuple(t.cpu() for t in consts),
                                  base.cpu(), **call)
    with pytest.raises(ValueError, match="shape"):
        fq.fabric_queue_multistep(carry, consts[:4] + (consts[4][:2],)
                                  + consts[5:], base, **call)
    # a fabric whose lane and side planes do not fit in shared memory
    L, k = 2048, 1
    big = [torch.zeros(s, dtype=torch.int32, device=cuda) for s in (
        (2 * L, 1), (2 * L, 1), (2 * L, 1), (16, L), (9, L, 2), (3, 2),
        (2,))]
    bconsts = [torch.zeros(s, dtype=torch.int32, device=cuda) for s in (
        (L, 2), (2, 2, k), (2, 2), (2, 2, k), (3, L), (3,))]
    with pytest.raises(ValueError, match="shared memory"):
        fq.fabric_queue_multistep(big, bconsts, base, **call)


# --- the LIF update ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", LIF_CARD_SHAPES)
@pytest.mark.parametrize("params", LIF_PARAMS)
def test_lif_kernel_matches_plain(cuda, shape, params):
    """Bit for bit, except where the plain version's float64 route
    rounds twice: each such element must be the kernel's exact single
    rounding (none is expected).  The shapes take every route of the
    kernel: 16-byte vectors, vectors with a scalar tail (33 x 127) and
    the scalar loop alone (a view 1 word past a 16-byte boundary)."""
    ((_, v, i, decay, v_th, v_reset),) = lif_cases((shape,), (params,))
    before = lk.lif_step.launches
    got = lk.lif_step(lif_on_card(v, cuda, shape),
                      lif_on_card(i, cuda, shape), decay=decay,
                      v_th=v_th, v_reset=v_reset)
    torch.cuda.synchronize()
    assert lk.lif_step.launches == before + 1
    plain = ref.lif_step(torch.from_numpy(v).to(cuda),
                         torch.from_numpy(i).to(cuda), decay, v_th, v_reset)
    got = tuple(t.cpu().numpy() for t in got)
    plain = tuple(t.cpu().numpy() for t in plain)
    _, unexplained = lif_double_roundings(v, i, decay, v_th, v_reset, got,
                                          plain)
    assert unexplained == 0


@pytest.mark.gpu
def test_lif_wrapper_validates_operands(cuda):
    v = torch.zeros((8, 128), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        lk.lif_step(v.double(), v.double(), decay=0.9, v_th=1.0,
                    v_reset=0.0)
    with pytest.raises(ValueError, match="contiguous"):
        lk.lif_step(v.t(), v.t(), decay=0.9, v_th=1.0, v_reset=0.0)
    with pytest.raises(ValueError, match="shape"):
        lk.lif_step(v, v[:4], decay=0.9, v_th=1.0, v_reset=0.0)
    with pytest.raises(ValueError, match="is on cpu"):
        lk.lif_step(v, v.cpu(), decay=0.9, v_th=1.0, v_reset=0.0)


# --- the MoE combine ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,K", COMBINE_ROUTINGS)
def test_moe_combine_repeats_on_the_card_and_equals_cpu(cuda, E, K, dtype):
    """``moe._combine`` twice on the card and once on the CPU on the same
    slot outputs (4 rows of 512 tokens, width 256, experts that
    overflow their slots), all three bit-equal: a fixed order, no
    atomics."""
    from repro_torch.models import moe as M
    B, S, D = 4, 512, 256
    C = max(int(-(-S * K * 1.25 // E)), 1)
    contrib, choice, pos, valid, _ = combine_case(E * K, B, S, E, K, D, C)
    args = [torch.from_numpy(a) for a in (contrib, choice, pos, valid)]
    args[0] = args[0].to(dtype)
    host = M._combine(*args)
    on_card = [a.to(cuda) for a in args]
    first = M._combine(*on_card)
    second = M._combine(*on_card)
    torch.cuda.synchronize()
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first.view(view), second.view(view))
    assert torch.equal(first.cpu().view(view), host.view(view))


def _ring4():
    pops = [cosim.Population(f"p{i}") for i in range(4)]
    projs = [cosim.Projection(i, (j,), 0.4) for i in range(4)
             for j in ((i + 1) % 4, (i - 1) % 4)]
    projs += [cosim.Projection(i, (i,), 0.3) for i in range(4)]
    return cosim.place(pops, projs, ring_topology(4), addr=AddressSpec())


def _spikes_agree(a, b, tol=1e-6):
    """Equal rasters, or a first differing tick whose differing neurons
    sit within ``tol`` of the threshold (1.0) on the side that did not
    spike.  ``raster`` and ``v`` lead with the tick axis."""
    diff = a.raster != b.raster
    if not diff.any():
        return True
    t0 = int(np.flatnonzero(diff.reshape(len(diff), -1).any(axis=1))[0])
    d = diff[t0]
    v_pre = np.where(a.raster[t0] == 0, a.v[t0], b.v[t0])[d]
    return bool(np.all(np.abs(v_pre - 1.0) <= tol))


@pytest.mark.gpu
def test_cosim_on_card_launches_and_matches_cpu(cuda):
    """An 8-tick closed loop over the multi-step fabric: one LIF launch a
    tick, only B3 for transport, and the CPU run's trajectory (same
    seed) up to near-threshold flips."""
    pl = _ring4()
    runs = {}
    for dev in (cuda, "cpu"):
        fab = pl.fabric(engine=EngineSpec("pallas", kernel="multistep"),
                        queues=QueuePolicy(capacity=128, flow="credit"),
                        device=dev)
        eng = cosim.CosimEngine(pl, fabric=fab, device=dev,
                                generator=torch.Generator().manual_seed(3))
        lk.lif_step.launches = fq.fabric_queue_multistep.launches = 0
        fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
        runs[str(dev)] = eng.run(8, record_state=True)
        counts = (lk.lif_step.launches, fq.fabric_queue_multistep.launches,
                  fq.fabric_queue_step.launches,
                  fq.fabric_queue_update.launches)
        if dev == cuda:
            assert counts[0] == 8 and counts[1] > 0 and counts[2:] == (0, 0)
        else:
            assert counts == (0, 0, 0, 0)
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert card.conservation_exact and int(card.drops.sum()) == 0
    assert _spikes_agree(cpu, card)


@pytest.mark.gpu
def test_snn_on_card_launches_and_matches_cpu(cuda):
    """Six ticks of the 2x2 array, one ``run_snn`` tick at a time: one
    LIF launch a tick on the card, and the CPU run's trajectory (same
    seed) up to near-threshold flips."""
    cfg = snn.SnnConfig(grid=(2, 2), neurons=256)
    out = {}
    for dev in (cuda, "cpu"):
        params, st = snn.init_snn(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
        lk.lif_step.launches = 0
        raster, v = [], []
        for _ in range(6):
            st, _ticks = snn.run_snn(params, cfg, st, 1)
            raster.append(st.spikes.cpu().numpy())
            v.append(st.v.cpu().numpy())
        out[str(dev)] = (lk.lif_step.launches, SimpleNamespace(
            raster=np.stack(raster), v=np.stack(v)))
    (n_card, card), (n_cpu, cpu) = out[str(cuda)], out["cpu"]
    assert n_card == 6 and n_cpu == 0
    assert cpu.raster.sum() > 0
    assert _spikes_agree(cpu, card)
    if np.array_equal(card.raster, cpu.raster):
        np.testing.assert_allclose(card.v, cpu.v, rtol=0, atol=1e-5)


# --- the AER encoder (B5) and decoder (B6) ----------------------------------

AER_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _host(t):
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("spec", aer_specs(card=True), ids=lambda s: s[0])
def test_aer_kernels_match_plain(cuda, spec):
    """Bit for bit (NaN where NaN) against the plain versions on the
    card; each encode case is also decoded by both."""
    a, b, n = aer_arrays(spec)
    dt = AER_DT[spec[5]]
    before = (aek.aer_encode.launches, adk.aer_decode.launches)
    if spec[1] == "encode":
        x, tau = (torch.from_numpy(v).to(cuda).to(dt) for v in (a, b))
        got = aek.aer_encode(x, tau, n)
        want = ref.aer_encode(x, tau, n)
        pairs = list(zip(want, got))
        pairs.append((ref.aer_decode(want[0], want[1], x.shape[1]),
                      adk.aer_decode(got[0], got[1], x.shape[1])))
        launched = (1, 1)
    else:
        idx = torch.from_numpy(a).to(cuda)
        val = torch.from_numpy(b).to(cuda).to(dt)
        pairs = [(ref.aer_decode(idx, val, n), adk.aer_decode(idx, val, n))]
        launched = (0, 1)
    torch.cuda.synchronize()
    assert (aek.aer_encode.launches - before[0],
            adk.aer_decode.launches - before[1]) == launched
    for w, g in pairs:
        assert w.dtype == g.dtype and w.shape == g.shape
        assert aer_mismatches(_host(w), _host(g)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", AER_ROUTE_CASES, ids=lambda c: c[0])
def test_aer_kernel_routes_match_plain(cuda, case):
    """Each route of B5 and B6 (``plan`` names the one a call takes) is
    bit-equal to the plain version, and each call counts one launch; x
    at an odd storage offset goes the scalar way and gives the same bits
    as the aligned copy."""
    name, kind, nb, block, budget, dtype, offset, route = case
    a, b, n = aer_route_arrays(case)
    dt = AER_DT[dtype]
    if kind == "encode":
        x = aer_offset_copy(a, dt, offset, cuda)
        tau = torch.from_numpy(b).to(cuda).to(dt)
        assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
        assert aek.plan(x)["route"] == route
        before = aek.aer_encode.launches
        got = aek.aer_encode(x, tau, n)
        assert aek.aer_encode.launches == before + 1
        pairs = list(zip(ref.aer_encode(x, tau, n), got))
        if offset:
            xa = x.clone()
            assert xa.data_ptr() % 16 == 0
            pairs += zip(aek.aer_encode(xa, tau, n), got)
            assert aek.aer_encode.launches == before + 2
    else:
        idx = torch.from_numpy(a).to(cuda)
        val = torch.from_numpy(b).to(cuda).to(dt)
        assert adk.plan(n, dt)["route"] == route
        before = adk.aer_decode.launches
        got = adk.aer_decode(idx, val, n)
        assert adk.aer_decode.launches == before + 1
        pairs = [(ref.aer_decode(idx, val, n), got)]
    torch.cuda.synchronize()
    for w, g in pairs:
        assert w.dtype == g.dtype and w.shape == g.shape
        assert aer_mismatches(_host(w), _host(g)) == 0


@pytest.mark.gpu
def test_aer_routes_all_reached(cuda):
    """``AER_ROUTE_CASES`` names every route of each kernel, and the
    full-width main-path shape takes the fast ones."""
    assert {c[7] for c in AER_ROUTE_CASES if c[1] == "encode"} \
        == set(aek.ROUTES)
    assert {c[7] for c in AER_ROUTE_CASES if c[1] == "decode"} \
        == set(adk.ROUTES)
    x = torch.zeros((16384, 1024), device=cuda)
    assert aek.plan(x)["route"] == "vector"
    assert adk.plan(1024)["route"] == "warp"
    assert adk.plan(1024)["dynamic_smem"] == 8 * 4 * (1024 + 32)


@pytest.mark.gpu
def test_aer_wrappers_validate_operands(cuda):
    x = torch.randn(4, 256, device=cuda)
    tau = torch.ones(4, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        aek.aer_encode(x.double(), tau.double(), 8)
    with pytest.raises(TypeError, match="must be torch.float32"):
        aek.aer_encode(x, tau.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="contiguous"):
        aek.aer_encode(x.t(), torch.ones(256, device=cuda), 4)
    with pytest.raises(ValueError, match="tau must be"):
        aek.aer_encode(x, tau[:2], 8)
    with pytest.raises(ValueError, match="budget"):
        aek.aer_encode(x, tau, 257)
    with pytest.raises(ValueError, match="block"):
        aek.aer_encode(torch.ones(1, 65537, device=cuda),
                       torch.ones(1, device=cuda), 8)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        adk.aer_decode(idx.long(), x[:, :8].contiguous(), 16)
    with pytest.raises(ValueError, match="shape"):
        adk.aer_decode(idx, x[:, :4].contiguous(), 16)
    with pytest.raises(ValueError, match="is on cpu"):
        adk.aer_decode(idx, x[:, :8].cpu(), 16)


@pytest.mark.gpu
def test_compress_with_feedback_on_card_matches_cpu(cuda):
    """The compress path on the card (tau, B5, B6) equals the CPU run on
    the same input, bit for bit, and conserves exactly."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2048, 700, generator=g)
    res = torch.randn(2048, 700, generator=g) * 0.01
    out = {}
    for dev in (cuda, "cpu"):
        ev, new_res, n = ops.compress_with_feedback(x.to(dev), res.to(dev))
        dec = ops.unpad_from_blocks(ops.aer_decompress(ev), n, x.shape)
        assert torch.equal(dec + new_res, x.to(dev) + res.to(dev))
        out[str(dev)] = [_host(t) for t in (*ev, new_res)]
    for w, c in zip(out["cpu"], out[str(cuda)]):
        assert aer_mismatches(w, c) == 0


@pytest.mark.gpu
def test_aer_allreduce_world_of_one_on_card(cuda):
    """``reduce_gradients(mode="aer_topk")`` over NCCL in a world of one:
    one B5 and one B6 launch a leaf, exact conservation."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        g = torch.Generator().manual_seed(1)
        grads = {"w": torch.randn(512, 300, generator=g).to(cuda),
                 "b": {"s": torch.randn(300, generator=g).to(cuda)}}
        st = sc.init_aer_states(grads)
        aek.aer_encode.launches = adk.aer_decode.launches = 0
        red, st2, words = sc.reduce_gradients(grads, st, mode="aer_topk")
        torch.cuda.synchronize()
        assert (aek.aer_encode.launches, adk.aer_decode.launches) == (2, 2)
        for r, s, x in zip(sc.tree_leaves(red), sc.tree_leaves(st2),
                           sc.tree_leaves(grads)):
            assert torch.equal(r + s.residual, x)
        assert int(words) == int(sum((r != 0).sum()
                                     for r in sc.tree_leaves(red)))
    finally:
        dist.destroy_process_group()


# --- the selective scan (B7) and the LM serve path ------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("spec", scan_specs(card=True), ids=lambda s: s[0])
def test_selective_scan_kernel_matches_plain(cuda, spec):
    """|kernel - plain| <= tol + tol·|plain| for y and h_final (the
    tolerance of ``_torch_cases.SCAN_TOL`` / ``SCAN_SERVE_TOL``)."""
    args = [torch.from_numpy(v).to(cuda) for v in scan_arrays(spec)]
    got = ssk.selective_scan(*args)
    want = ref.selective_scan(*args)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        worst = scan_errors(w.cpu().numpy(), g.cpu().numpy())[2]
        assert worst <= spec[3], (spec[0], worst)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [s for s in scan_specs(card=True)
                                  if s[0].startswith("edge-")],
                         ids=lambda s: s[0])
def test_selective_scan_misaligned_operands_match_plain(cuda, spec):
    """Operands one element into a larger buffer (4-byte copies, no
    16-byte ones) give what aligned ones give, within tolerance of the
    plain version."""
    args = [torch.from_numpy(v).to(cuda) for v in scan_arrays(spec)]
    want = ref.selective_scan(*args)
    ops = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
           for t in args]
    assert all(t.data_ptr() % 16 for t in ops)
    got = ssk.selective_scan(*ops)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        worst = scan_errors(w.cpu().numpy(), g.cpu().numpy())[2]
        assert worst <= spec[3], (spec[0], worst)


@pytest.mark.gpu
def test_selective_scan_wrapper_validates_operands(cuda):
    x = torch.zeros((2, 8, 16), device=cuda)
    bc = torch.zeros((2, 8, 4), device=cuda)
    a = -torch.ones((16, 4), device=cuda)
    with pytest.raises(TypeError):
        ssk.selective_scan(x.double(), x, bc, bc, a)
    with pytest.raises(ValueError, match="contiguous"):
        ssk.selective_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                           x, bc, bc, a)
    with pytest.raises(ValueError, match="shapes"):
        ssk.selective_scan(x, x, bc[:, :4].contiguous(), bc, a)
    wide = torch.zeros((2, 8, 33), device=cuda)
    with pytest.raises(ValueError, match="N = 33"):
        ssk.selective_scan(x, x, wide, wide, -torch.ones((16, 33),
                                                         device=cuda))
    # the raw wrapper builds no graph (gradients go through
    # SelectiveScanFn, whose backward is the backward kernel)
    y, h = ssk.selective_scan(x.clone().requires_grad_(), x, bc, bc, a)
    assert not y.requires_grad and not h.requires_grad
    dy = torch.zeros_like(x)
    with pytest.raises(ValueError, match="dy"):
        ssk.selective_scan_bwd(x, x, bc, bc, a, dy[:, :4])
    with pytest.raises(ValueError, match="dh_final"):
        ssk.selective_scan_bwd(x, x, bc, bc, a, dy,
                               torch.zeros((2, 16, 3), device=cuda))
    with pytest.raises(TypeError):
        ssk.selective_scan_bwd(x, x, bc, bc, a, dy.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("spec", scan_specs(card=True), ids=lambda s: s[0])
def test_selective_scan_bwd_kernel_matches_plain(cuda, spec, dh):
    """Each of dx, ddt, dB, dC, dA within ``scan_bwd_tol(spec)`` x
    max|plain| of ``ref.selective_scan_bwd``, and the same bits on a
    second run (no float atomics)."""
    args = [torch.from_numpy(v).to(cuda) for v in scan_arrays(spec)]
    dy, dhf = (torch.from_numpy(v).to(cuda)
               for v in scan_cotangents(spec, dh))
    dhf = dhf if dh else None
    got = ssk.selective_scan_bwd(*args, dy, dhf)
    again = ssk.selective_scan_bwd(*args, dy, dhf)
    want = ref.selective_scan_bwd(*args, dy, dhf)
    torch.cuda.synchronize()
    tol = scan_bwd_tol(spec)
    for w, g, g2 in zip(want, got, again):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, g2)
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()) \
            + 1e-30, spec[0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 40, 24, 16), (1, 33, 65, 5)])
def test_selective_scan_fn_on_card_matches_autograd_through_plain(cuda,
                                                                  shape):
    """``SelectiveScanFn`` on CUDA tensors (B7 and its backward kernel)
    routes each cotangent as autograd through the plain scan does."""
    B, S, d, N = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    ins = [torch.randn((B, S, d), generator=g, device=cuda),
           torch.rand((B, S, d), generator=g, device=cuda) * 0.3,
           torch.randn((B, S, N), generator=g, device=cuda),
           torch.randn((B, S, N), generator=g, device=cuda),
           -torch.rand((d, N), generator=g, device=cuda) - 0.1]
    dy = torch.randn((B, S, d), generator=g, device=cuda)
    dh = torch.randn((B, d, N), generator=g, device=cuda)
    a1 = [t.clone().requires_grad_() for t in ins]
    a2 = [t.clone().requires_grad_() for t in ins]
    n0, b0 = ssk.selective_scan.launches, ssk.selective_scan_bwd.launches
    got = torch.autograd.grad(ops.selective_scan(*a1), a1, (dy, dh))
    assert (ssk.selective_scan.launches - n0,
            ssk.selective_scan_bwd.launches - b0) == (1, 1)
    want = torch.autograd.grad(ref.selective_scan(*a2), a2, (dy, dh))
    for w, v in zip(want, got):
        assert float((v - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.gpu
def test_train_smoke_on_card_launches_scan_forward_and_backward(cuda):
    """Three training steps of falcon-mamba's smoke config on the card:
    with "full" remat each Mamba layer's scan runs in the forward and in
    the recompute, its backward kernel once; the metrics are finite."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    cfg = get_smoke_config("falcon_mamba_7b")
    model = build_model(cfg, seed=0, device=cuda)
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    state = tl.init_state(model, run)
    step = tl.make_train_step(model, run)
    data = SyntheticLM(cfg.vocab, 32, 4, seed=1)
    for s in range(3):
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in data.batch(s).items()}
        ssk.selective_scan.launches = ssk.selective_scan_bwd.launches = 0
        state, m = step(state, batch)
        assert (ssk.selective_scan.launches,
                ssk.selective_scan_bwd.launches) == (2 * cfg.n_layers,
                                                     cfg.n_layers)
        assert all(bool(torch.isfinite(v)) for v in m.values())


@pytest.mark.gpu
def test_dp_aer_step_world_of_one_on_card(cuda):
    """One data-parallel ``aer_topk`` step of falcon-mamba's smoke config
    in a world of one over NCCL (``make_host_mesh(data=1)``,
    ``make_rules(fsdp=False)``): one B5 and one B6 launch a reference
    leaf (the stack's leaves stacked over layers), the scan's forward
    twice and its backward once a layer; finite metrics, wire words > 0,
    and the residuals in the stacked layout."""
    import torch.distributed as dist
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime import train_loop as tl
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cfg = get_smoke_config("falcon_mamba_7b")
        model = build_model(cfg, seed=0, device=cuda)
        run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2,
                        dp_reduce="aer_topk", aer_frac=0.05, fsdp=False)
        rules = make_rules(make_host_mesh(data=1), fsdp=False)
        state = tl.init_state(model, run)
        step = tl.make_train_step(model, run, rules)
        leaves = tl.ReferenceLeaves(model).members
        assert state.aer["stack.pos0.ln1.scale"].residual.shape == (
            cfg.n_layers, cfg.d_model)
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in
                 SyntheticLM(cfg.vocab, 32, 4, seed=1).batch(0).items()}
        for f in (aek.aer_encode, adk.aer_decode, ssk.selective_scan,
                  ssk.selective_scan_bwd):
            f.launches = 0
        state, m = step(state, batch)
        torch.cuda.synchronize()
        assert (aek.aer_encode.launches, adk.aer_decode.launches) == (
            len(leaves), len(leaves))
        assert (ssk.selective_scan.launches,
                ssk.selective_scan_bwd.launches) == (2 * cfg.n_layers,
                                                     cfg.n_layers)
        assert all(bool(torch.isfinite(v)) for v in m.values())
        assert float(m["wire_words"]) > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "jamba_v01_52b"])
def test_train_smoke_on_card_is_deterministic(cuda, arch):
    """Two runs of three steps from the same seed end with the same bits
    on the card: the MoE dispatch's and the embedding's backward run
    under deterministic algorithms (jamba's also through B7's backward
    kernel)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    cfg = get_smoke_config(arch)
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    data = SyntheticLM(cfg.vocab, 32, 4, seed=1)
    ends = []
    for _ in range(2):
        model = build_model(cfg, seed=0, device=cuda)
        state = tl.init_state(model, run)
        step = tl.make_train_step(model, run)
        for s in range(3):
            state, m = step(state, {k: torch.from_numpy(v).to(cuda)
                                    for k, v in data.batch(s).items()})
        assert all(bool(torch.isfinite(v)) for v in m.values())
        ends.append(state)
    for k, p in ends[0].params.items():
        assert torch.equal(p, ends[1].params[k]), k


@pytest.mark.gpu
def test_serve_smoke_on_card_launches_scan_in_prefill_only(cuda):
    cfg = get_smoke_config("falcon_mamba_7b")
    model = build_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 12), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    ssk.selective_scan.launches = 0
    res = serve.generate(model, {"tokens": toks}, 6)
    assert ssk.selective_scan.launches == cfg.n_layers
    assert res.tokens.shape == (2, 6) and int(res.tokens.max()) < cfg.vocab
    assert torch.isfinite(res.logits.float()).all()
    _, cache = model.prefill({"tokens": toks})
    ssk.selective_scan.launches = 0
    model.decode_step(cache, res.tokens[:, :1], None)
    assert ssk.selective_scan.launches == 0


@pytest.mark.gpu
def test_lm_on_card_matches_cpu(cuda):
    """The same float32-compute parameters on the card (B7) and the CPU
    (the plain scan): logits to the serving contract's 2e-4."""
    cfg = get_smoke_config("falcon_mamba_7b").with_(
        compute_dtype=torch.float32)
    cpu_model = build_model(cfg, seed=2, device="cpu")
    card = LM(cfg, device=cuda)
    card.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(3))
    want, _ = cpu_model.forward({"tokens": toks})
    got, _ = card.forward({"tokens": toks.to(cuda)})
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def _counted(fn):
    from repro_torch.launch import cost
    with cost.Counter() as c:
        out = fn()
    return out, c.result()["kernels"]


def _like(a, b):
    """Same shapes and dtypes, leaf for leaf."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (tuple(x.shape), x.dtype) == (tuple(y.shape), y.dtype)


@pytest.mark.gpu
def test_meta_routes_match_the_kernels(cuda):
    """B5, B6, B7 and B7's backward on meta tensors (the dry-run's
    route) return the kernels' shapes and dtypes, and the wrappers
    declare the same bytes on both devices."""
    spec = aer_specs(card=True)[0]
    assert spec[1] == "encode" and spec[5] == "float32"
    xa, taua, budget = aer_arrays(spec)
    x, tau = (torch.from_numpy(v).to(cuda) for v in (xa, taua))
    card, meta = ({}, {})
    for dev, got in ((cuda, card), ("meta", meta)):
        xd, td = x.to(dev), tau.to(dev)
        got["enc"], got["k_enc"] = _counted(
            lambda: ops.aer_encode(xd, td, budget))
        got["dec"], got["k_dec"] = _counted(
            lambda: ops.aer_decode(got["enc"][0], got["enc"][1],
                                   xd.shape[1]))
    _like(card["enc"], meta["enc"])
    _like((card["dec"],), (meta["dec"],))
    assert (card["k_enc"], card["k_dec"]) == (meta["k_enc"], meta["k_dec"])
    args = [torch.from_numpy(v).to(cuda)
            for v in scan_arrays(scan_specs(card=True)[0])]
    for dev, got in ((cuda, card), ("meta", meta)):
        a = [t.detach().to(dev, copy=True).requires_grad_() for t in args]

        def run():
            y, h = ops.selective_scan(*a)
            (y.sum() + h.sum()).backward()
            return (y, h) + tuple(t.grad for t in a)
        got["scan"], got["k_scan"] = _counted(run)
    _like(card["scan"], meta["scan"])
    assert card["k_scan"] == meta["k_scan"]
    assert set(meta["k_scan"]) == {"selective_scan", "selective_scan_bwd"}
