"""The per-step kernel engine's step loop (``network._slot_run``): the
static-carry step that the card captures into a CUDA graph and replays,
run here on ``device="cpu"`` in the plain loop of the same plan.

It is held field for field against the eager loop of ``body``
(``engine="reference"``, which shares no capture code) and against the
reference package's ``engine="reference"`` ``FabricResult``, on the
ring-2 anchor, ring-16 under credit flow and the 2x4-mesh in-fabric
multicast (K = 2), at step counts on either side of every boundary of
the plan (the default graph length and, with ``GRAPH_STEPS`` set to 4,
a short one); and the plan itself is checked in pure Python.  The captured run itself is held
against the eager one on the card in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import network as jnet
from repro.core import traffic as jtr
from repro.core.router import AddressSpec as JAddressSpec
from repro.core.router import MulticastTable as JMulticastTable
from repro.core.router import mesh2d_topology as j_mesh2d
from repro.core.router import ring_topology as j_ring
from repro_torch import interop
from repro_torch.core import fabric as tfab
from repro_torch.core import network as tnet
from repro_torch.core import router as trt

from _torch_cases import (anchor_arrays, hot_spot_arrays,
                          mesh_multicast_case, spec_of)
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

G = tnet.GRAPH_STEPS
M = tnet.GRAPH_MIN_REPLAYS
CPU = "cpu"


def _cell(name):
    """``(reference Fabric, port Fabric kwargs, (src, t, dest))``."""
    if name == "anchor":
        return (jfab.Fabric(j_ring(2), engine="reference",
                            queues=jfab.QueuePolicy(max_burst=1)),
                dict(topo=trt.ring_topology(2),
                     queues=tfab.QueuePolicy(max_burst=1)),
                anchor_arrays(24))
    if name == "ring16_credit":
        return (jfab.Fabric(j_ring(16), engine="reference",
                            queues=jfab.QueuePolicy(capacity=6,
                                                    flow="credit")),
                dict(topo=trt.ring_topology(16),
                     queues=tfab.QueuePolicy(capacity=6, flow="credit")),
                hot_spot_arrays(16, 4, 300.0, 0.65, seed=2))
    members, arrays = mesh_multicast_case(8 * 4)
    return (jfab.Fabric(j_mesh2d(2, 4), addr=JAddressSpec(),
                        engine="reference",
                        mcast=jfab.MulticastPolicy(
                            "in_fabric", JMulticastTable(members))),
            dict(topo=trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                 mcast=tfab.MulticastPolicy(
                     "in_fabric", trt.MulticastTable(members))),
            arrays)


def _jspec(arrays):
    return jtr.TrafficSpec(*(jnp.asarray(np.asarray(a, np.int32))
                             for a in arrays))


def _static_and_eager(kw, spec, steps):
    """The kernel engine's run (the static-carry plan) and the eager
    ``body`` loop, on the CPU, at ``steps`` (None: the plan's own bound);
    returns both results and the compiled fabric."""
    cf = tfab.Fabric(**kw, device=CPU, engine="pallas").compile(
        spec, max_steps=steps)
    got = cf.run(spec, max_steps=steps)
    eager = tfab.Fabric(**kw, device=CPU, engine="reference").run(
        spec, max_steps=steps)
    return got, eager, cf


@pytest.mark.parametrize("max_steps,graph_steps,plan", [
    (0, 64, (0, 0, 0)), (1, 64, (1, 0, 0)), (2, 64, (2, 0, 0)),
    (63, 64, (2, 0, 61)), (64, 64, (2, 0, 62)), (65, 64, (2, 0, 63)),
    (66, 64, (2, 1, 0)), (67, 64, (2, 1, 1)), (197, 64, (2, 3, 3)),
    (15252, 64, (2, 238, 18)), (15252, 32, (2, 476, 18)),
    (15252, 128, (2, 119, 18)), (-3, 64, (0, 0, 0))])
def test_graph_plan(max_steps, graph_steps, plan):
    assert tnet._graph_plan(max_steps, graph_steps, 1) == plan


@pytest.mark.parametrize("max_steps,plan", [
    (33, (2, 0, 31)), (34, (2, 0, 32)), (65, (2, 0, 63)),
    (66, (2, 2, 0)), (67, (2, 2, 1)), (100, (2, 3, 2)),
    (15252, (2, 476, 18))])
def test_graph_plan_min_replays(max_steps, plan):
    """The default plan: a run with room for one replay stays eager."""
    assert (G, M) == (32, 2)
    assert tnet._graph_plan(max_steps, G, M) == plan


def test_graph_plan_covers_every_step_once():
    for g in (1, 4, 32, 64, 128):
        for m in (1, 2, 3):
            for n in range(0, (m + 2) * g + 9):
                head, replays, tail = tnet._graph_plan(n, g, m)
                assert head + replays * g + tail == n
                assert head == min(n, 2)
                assert replays == 0 or replays >= m
                assert 0 <= tail < (g if replays else m * g)


def test_static_carry_owns_every_tensor_and_keeps_the_planes():
    """The static carry has no two fields on one tensor (the reset carry
    shares ``link.xl.mode`` with ``prev_mode_l``), and keeps the planes
    and logs that the step writes in place as the same tensors."""
    q = torch.full((4, 3), 2**30, dtype=torch.int32)
    s = tnet._slot_init(2, 5, q, q.clone(), q.clone(),
                        torch.zeros((2, 2), dtype=torch.int32),
                        torch.ones(2, dtype=torch.int32))
    assert s.prev_mode_l is s.link.xl.mode
    st = tnet._static_carry(s)
    leaves = tnet._leaves(st)
    assert len({id(t) for t in leaves}) == len(leaves)
    assert st.q_time is s.q_time and st.log_inj is s.log_inj
    assert torch.equal(st.prev_mode_l, st.link.xl.mode)
    # a step result that hands one field's static tensor to another
    # (here prev_mode_l <- link.xl.mode) is read before it is written
    new = st._replace(prev_mode_l=st.n_sw, n_sw=st.n_sw + 7)
    old_n_sw = st.n_sw.clone()
    tnet._copy_carry(st, new)
    assert torch.equal(st.prev_mode_l, old_n_sw)
    assert torch.equal(st.n_sw, old_n_sw + 7)


def test_kernel_engine_runs_the_static_step(monkeypatch):
    """Step 0 through ``body``, every later step through the static
    carry: ``body`` sees one carry object for all of them."""
    calls = []
    real = tnet._slot_step_body

    def spy(*a, **k):
        body = real(*a, **k)

        def counted(s, step_i):
            calls.append((id(s), step_i))
            return body(s, step_i)
        return counted

    monkeypatch.setattr(tnet, "_slot_step_body", spy)
    # a fresh runner cache, so the bucket's runner builds its body here
    monkeypatch.setattr(tnet, "_RUNNERS", {})
    _, kw, arrays = _cell("ring16_credit")
    spec = spec_of(*arrays)
    steps = M * G + 7
    cf = tfab.Fabric(**kw, device=CPU, engine="pallas").compile(
        spec, max_steps=steps)
    cf.run(spec, max_steps=steps)
    assert cf.graph == {"graph_steps": G, "head": 2, "replays": M,
                        "tail": 5, "captured": False, "captures": 0}
    assert [i for _, i in calls] == [0] + [1] * (steps - 1)
    assert len({c for c, _ in calls[1:]}) == 1


@pytest.mark.parametrize("cell", ["anchor", "ring16_credit",
                                  "mesh2x4_multicast"])
def test_static_loop_matches_eager_and_reference(cell):
    """Whole runs: every event delivered, the plan's replays > 0."""
    jfabric, kw, arrays = _cell(cell)
    spec = spec_of(*arrays)
    got, eager, cf = _static_and_eager(kw, spec, None)
    assert cf.graph["replays"] > 0
    tnet.assert_results_equal(got, eager, f"{cell}: static vs eager")
    jres = jfabric.run(_jspec(arrays))
    jnet.assert_results_equal(jres, interop.result_to_numpy(got), cell)
    assert int(got.delivered) == got.injected


@pytest.mark.parametrize("steps", [0, 1, 2, G - 1, G, G + 1, G + 2, G + 3,
                                   3 * G + 5, 2 * G + 1, 2 * G + 2])
def test_binding_steps_match_eager_and_reference(steps):
    """ring-16 under credit flow, cut at every boundary of the default
    plan (2·G + 1 steps: one replay's room, run eager; 2·G + 2: the
    first run that replays); the longest cut still leaves its queues
    backlogged."""
    jfabric, kw, arrays = _cell("ring16_credit")
    spec = spec_of(*arrays)
    got, eager, cf = _static_and_eager(kw, spec, steps)
    assert cf.bucket[4] == steps
    tnet.assert_results_equal(got, eager, f"static vs eager at {steps}")
    jres = jfabric.run(_jspec(arrays), max_steps=steps)
    jnet.assert_results_equal(jres, interop.result_to_numpy(got),
                              f"at {steps} steps")
    if steps == 3 * G + 5:
        assert 0 < int(got.delivered) < got.injected


@pytest.mark.parametrize("cell", ["ring16_credit", "mesh2x4_multicast"])
@pytest.mark.parametrize("steps", [0, 1, 2, 3, 5, 6, 7, 17])
def test_short_graph_boundaries_match_eager(cell, steps, monkeypatch):
    """A graph of 4 steps, replayed from the first: every boundary of the
    plan within 17 steps."""
    monkeypatch.setattr(tnet, "GRAPH_STEPS", 4)
    monkeypatch.setattr(tnet, "GRAPH_MIN_REPLAYS", 1)
    _, kw, arrays = _cell(cell)
    got, eager, cf = _static_and_eager(kw, spec_of(*arrays), steps)
    assert cf.graph["replays"] == max(steps - 2, 0) // 4
    tnet.assert_results_equal(got, eager, f"{cell} at {steps}")
