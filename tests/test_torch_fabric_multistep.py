"""``kernel="multistep"`` of the port on ``device="cpu"`` against the JAX
reference.

The same numpy-seeded traffic goes to both packages; the port's
multi-step engine (on the CPU, the plain ``ref.fabric_queue_multistep``
loop over the engine's step) is held against the reference's
``engine="reference"`` with ``network.assert_results_equal``, bit for
bit, telemetry included.  The cases mirror the reference's
``TestMultistepEngine`` (``tests/test_fabric_queue_kernel.py``).  The
packed carry is held against the reference's channel for channel, and
the plain version's launch schedule against one flat launch, and the
card's cases reach the kernel paths they claim (the 14x14 mesh case in
``test_torch_fabric_multistep_mesh.py``; the column checks of every
case's plain run in ``_columns.py``, ``_wide.py`` and ``_mesh.py``).
The CUDA kernel itself is held against the plain version on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import network as net
from repro.core import traffic as jtr
from repro.core.link import PAPER_TIMING, SERIAL_LVDS_TIMING
from repro.core.link import per_link_timing as j_per_link_timing
from repro.core.router import (AddressSpec, MulticastTable, mesh2d_topology,
                               ring_topology)
from repro_torch import interop
from repro_torch.core import fabric as tfab
from repro_torch.core import link as tl
from repro_torch.core import network as tnet
from repro_torch.core import router as trt
from repro_torch.kernels import ref as tref

import _torch_multistep as M
from _torch_cases import (carry_err, clone, hot_spot_arrays,
                          mesh_multicast_case, multistep_operands,
                          run_schedule)
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _hot(seed, n_chips, epc):
    return hot_spot_arrays(n_chips, epc, 100.0, 0.9, seed)


def _both(arrays):
    arrs = [np.asarray(a, np.int32) for a in arrays]
    return (jtr.TrafficSpec(*map(jnp.asarray, arrs)),
            interop.from_reference(traffic=arrs).traffic)


def _ms(chunk):
    return tfab.EngineSpec("pallas", kernel="multistep", chunk_size=chunk)


def _same(jres, tres, ctx):
    got = interop.result_to_numpy(tres)
    net.assert_results_equal(jres, got, ctx)
    for f in net.RESULT_FIELDS:
        assert np.asarray(getattr(got, f)).dtype == np.int32, (ctx, f)


@functools.lru_cache(maxsize=None)
def _reference(seed, n_chips, epc, max_steps=None):
    """The reference engine's ring result (cached: several chunks and
    step bounds are held against one run)."""
    jspec, _ = _both(_hot(seed, n_chips, epc))
    return jfab.Fabric(ring_topology(n_chips), engine="reference").run(
        jspec, max_steps=max_steps)


# --- the engine against the reference ----------------------------------

@pytest.mark.parametrize("chunk", [1, 16, 64, 100_000])
def test_chunk_matrix_vs_reference(chunk):
    _, tspec = _both(_hot(0, 8, 8))
    fab = tfab.Fabric(trt.ring_topology(8), engine=_ms(chunk), device=CPU)
    tres = fab.run(tspec)
    _same(_reference(0, 8, 8), tres, f"chunk={chunk}")
    assert int(tres.delivered) == tres.injected


@pytest.mark.parametrize("flow,cap,xon", [("drop", 12, None),
                                          ("credit", 6, None),
                                          ("onoff", 6, 3)])
def test_flow_modes(flow, cap, xon):
    jspec, tspec = _both(_hot(1, 8, 12))
    jres = jfab.Fabric(ring_topology(8), engine="reference",
                       queues=jfab.QueuePolicy(capacity=cap, flow=flow,
                                               xon=xon)).run(jspec)
    tres = tfab.Fabric(trt.ring_topology(8), engine=_ms(16), device=CPU,
                       queues=tfab.QueuePolicy(capacity=cap, flow=flow,
                                               xon=xon)).run(tspec)
    _same(jres, tres, flow)
    assert int(tres.delivered) + int(tres.drops) == tres.injected
    if flow == "drop":
        assert int(tres.drops) > 0          # the capacity binds
    else:
        assert int(tres.telemetry.stall_steps.sum()) > 0


def test_in_fabric_multicast_k2():
    """K = 2 append lanes per pop (a tree branching past its source)."""
    members, arrays = mesh_multicast_case(48)
    jspec, tspec = _both(arrays)
    jres = jfab.Fabric(mesh2d_topology(2, 4), addr=AddressSpec(),
                       engine="reference",
                       mcast=jfab.MulticastPolicy(
                           "in_fabric", MulticastTable(members))).run(jspec)
    fab = tfab.Fabric(trt.mesh2d_topology(2, 4), addr=trt.AddressSpec(),
                      engine=_ms(16), device=CPU,
                      mcast=tfab.MulticastPolicy(
                          "in_fabric", trt.MulticastTable(members)))
    tres = fab.run(tspec)
    _same(jres, tres, "in_fabric multistep")
    assert fab.compiled_buckets[0][7] == 2
    assert int(tres.delivered) == tres.injected


@pytest.mark.parametrize("max_steps", [23, 64])
def test_binding_max_steps(max_steps):
    _, tspec = _both(_hot(2, 8, 8))
    tres = tfab.Fabric(trt.ring_topology(8), engine=_ms(16),
                       device=CPU).run(tspec, max_steps=max_steps)
    _same(_reference(2, 8, 8, max_steps), tres, f"max_steps={max_steps}")
    assert int(tres.delivered) < tres.injected


def test_heterogeneous_link_timing():
    assign = [0, 1] * 4
    jt = j_per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING], assign)
    tt = tl.per_link_timing([tl.PAPER_TIMING, tl.SERIAL_LVDS_TIMING],
                            assign)
    jspec, tspec = _both(_hot(3, 8, 6))
    jres = jfab.Fabric(ring_topology(8), timing=jt,
                       engine="reference").run(jspec)
    tres = tfab.Fabric(trt.ring_topology(8), timing=tt, engine=_ms(16),
                       device=CPU).run(tspec)
    _same(jres, tres, "per-link timing")


def test_bucket_keys():
    """Each kernel binds its own bucket, the reference's tuple; the
    chunk keys it only under "multistep"."""
    jspec, tspec = _both(_hot(4, 8, 6))
    buckets = []
    for j_eng, t_eng in [(jfab.EngineSpec("pallas"), "pallas"),
                         (jfab.EngineSpec("pallas", kernel="multistep",
                                          chunk_size=16), _ms(16))]:
        jcf = jfab.Fabric(ring_topology(8), engine=j_eng).compile(
            jspec, warm=False)
        tcf = tfab.Fabric(trt.ring_topology(8), engine=t_eng,
                          device=CPU).compile(tspec)
        assert tcf.bucket == jcf.bucket
        buckets.append(tcf)
    step, ms = buckets
    assert step.bucket[-2:] == ("step", 0)
    assert ms.bucket[-2:] == ("multistep", 16)
    tnet.assert_results_equal(step.run(tspec), ms.run(tspec), "step vs ms")


# --- the packed carry and the plain launch -----------------------------

def test_packed_carry_matches_reference():
    """``_pack_slot_state(_slot_init(...))`` channel for channel, the
    port's log plane compared up to E (its last column is scratch)."""
    rng = np.random.default_rng(5)
    L, E, C = 4, 10, 12
    q_time = rng.integers(0, 900, (2 * L, C)).astype(np.int32)
    q_dest = rng.integers(0, 5, (2 * L, C)).astype(np.int32)
    q_inj = rng.integers(0, 900, (2 * L, C)).astype(np.int32)
    sizes = rng.integers(0, C, (L, 2)).astype(np.int32)
    init_tx = np.array([1, 0, 1, 1], np.int32)
    jc = net._pack_slot_state(net._slot_init(
        L, E, *map(jnp.asarray, (q_time, q_dest, q_inj, sizes, init_tx))))
    tc = tnet._pack_slot_state(tnet._slot_init(
        L, E, *map(torch.from_numpy, (q_time, q_dest, q_inj, sizes,
                                      init_tx))))
    assert len(tc) == len(jc) == 7
    assert tnet._MS_LANES == net._MS_LANES
    assert tnet._MS_SIDES == net._MS_SIDES
    for i, (j, t) in enumerate(zip(jc, tc)):
        j, t = np.asarray(j), t.numpy()
        assert t.dtype == j.dtype == np.int32, i
        if i == 5:
            assert t.shape == (3, E + 1)
            t = t[:, :E]
        np.testing.assert_array_equal(t, j, err_msg=f"channel {i}")


@pytest.mark.parametrize("L,E,C", [(1, 2048, 2048), (16, 768, 768),
                                   (10, 1000, 1000)])
def test_slot_carry_bytes(L, E, C):
    assert tnet.slot_carry_bytes(L, E, C) == net.slot_carry_bytes(L, E, C)
    if (L, E, C) == (16, 768, 768):
        assert tnet.slot_carry_bytes(L, E, C) == 306_312


def test_plain_schedule_equals_one_flat_launch():
    """chunk 4 with max_steps 5: the second launch runs exactly one step
    (min(chunk, max_steps - base)), and the schedule equals one flat
    5-step launch; a launch at base >= max_steps changes nothing."""
    kw = dict(topo=trt.ring_topology(4),
              queues=tfab.QueuePolicy(capacity=3, flow="credit"))
    carry, consts, step_fn, plan = multistep_operands(
        kw, _hot(6, 4, 8), 5, CPU)

    def launch(chunk):
        return lambda c, b, ch: tref.fabric_queue_multistep(
            c, consts, b, step_fn=step_fn, chunk=chunk, max_steps=5)

    chunked = run_schedule(launch(4), clone(carry), 5, 4)
    flat = run_schedule(launch(5), clone(carry), 5, 5)
    assert carry_err(chunked, flat, plan.E) == 0
    one_more = tref.fabric_queue_multistep(
        clone(flat), consts, torch.tensor([5], dtype=torch.int32),
        step_fn=step_fn, chunk=4, max_steps=5)
    assert carry_err(one_more, flat, plan.E) == 0
    six = run_schedule(
        lambda c, b, ch: tref.fabric_queue_multistep(
            c, consts, b, step_fn=step_fn, chunk=ch, max_steps=6),
        clone(carry), 6, 4)
    assert carry_err(six, flat, plan.E) != 0     # a step is not a no-op


@pytest.mark.parametrize("name", [n for n in sorted(M.CASE_CLAIMS)
                                  if n not in M.MESH])
def test_card_cases_reach_the_paths_they_claim(name):
    """Shapes, per-link timing, stalls under the stall modes, the tier
    of shared memory each case launches at on an H100 (``just_fits`` is
    the widest ring-16 whose q_time plane fits), and clocks within a few
    hundred ns of ``BIG_NS`` or past it (``_torch_multistep``; the
    14x14 mesh case and the column checks run in the other
    ``test_torch_fabric_multistep_*.py`` files)."""
    M.check_case_claims(name)
