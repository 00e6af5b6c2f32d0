"""The slot engine's queue step: the port's plain versions against the
reference's oracles AND its Pallas kernels (interpret mode, as the JAX
tests run them).  The CUDA kernels are held against these plain versions
on the card in ``test_torch_kernels_cuda.py``.

Inputs come from numpy with the edge cases of the kernels' contract:
all-``BIG_NS`` rows, fully released rows, release-time ties (lowest
slot wins), values next to ``BIG_NS`` and clocks at or past it, and
pop/append lanes whose queue id is >= Q (skipped).  Every output is
integer and compared exactly, dtype included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fabric_queue as jfq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fabric_queue as tfq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_cases import BIG, scan_case, update_case
from _torch_cases import planes as _planes
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SHAPES = [(4, 7), (2, 5), (16, 96), (32, 768)]
SCAN_OUTS = ("pend", "r_min", "nxt", "amin", "busy", "head_route")


def _rpb(nq):
    return jops._rows_per_block_for(nq, 8)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _check(want, got, names):
    for w, g, name in zip(want, got, names):
        g = g.cpu().numpy()
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=name)


@pytest.mark.parametrize("nq,nc", SHAPES)
def test_scan_matches_oracle_and_pallas(nq, nc):
    rng = np.random.default_rng(nq * 1000 + nc)
    q, qd, t = scan_case(rng, nq, nc)
    got = tref.fabric_queue_scan(_t(q), _t(qd), _t(t))
    want = jref.fabric_queue_scan(jnp.asarray(q), jnp.asarray(qd),
                                  jnp.asarray(t))
    _check(want, got, SCAN_OUTS)
    pallas = jfq.fabric_queue_step_pallas(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(t),
        rows_per_block=_rpb(nq), interpret=True)
    _check(pallas, got, SCAN_OUTS)
    # the all-BIG_NS row resolves to slot 0 and reads q_dest[0, 0]
    assert int(got[3][0]) == 0 and int(got[5][0]) == qd[0, 0]


def test_scan_ties_pick_lowest_slot():
    q = np.array([[50, 10, 10, BIG], [BIG] * 4, [7, 7, 7, 7],
                  [BIG, 3, BIG, 3]], np.int32)
    qd = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [4, 3, 2, 1],
                   [8, 7, 6, 5]], np.int32)
    t = np.full(4, 100, np.int32)
    got = tops.fabric_queue_scan(_t(q), _t(qd), _t(t))
    np.testing.assert_array_equal(got[3].numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(got[5].numpy(), [2, 5, 4, 7])


@pytest.mark.parametrize("nq,nc", SHAPES)
@pytest.mark.parametrize("k", [1, 4])
def test_update_matches_oracle_and_pallas(nq, nc, k):
    rng = np.random.default_rng(nq * 7 + nc + k)
    planes = _planes(rng, nq, nc)
    lanes = update_case(rng, nq, nc, k)
    got = tops.fabric_queue_update(*map(_t, planes), *map(_t, lanes))
    want = jref.fabric_queue_update(*map(jnp.asarray, planes),
                                    *map(jnp.asarray, lanes))
    _check(want, got, ("q_time", "q_dest", "q_inj"))
    pallas = jfq.fabric_queue_update_pallas(
        *map(jnp.asarray, planes), *map(jnp.asarray, lanes),
        rows_per_block=_rpb(nq), interpret=True)
    _check(pallas, got, ("q_time", "q_dest", "q_inj"))


def test_update_is_in_place():
    rng = np.random.default_rng(0)
    planes = [_t(p) for p in _planes(rng, 4, 7)]
    out = tref.fabric_queue_update(*planes,
                                   *map(_t, update_case(rng, 4, 7, 2)))
    assert all(o is p for o, p in zip(out, planes))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never runs the plain version: CPU tensors raise
    (``ops`` is what sends them to ``ref``)."""
    rng = np.random.default_rng(1)
    q, qd, t = (_t(a) for a in scan_case(rng, 4, 7))
    n0 = tfq.fabric_queue_step.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfq.fabric_queue_step(q, qd, t)
    lanes = map(_t, update_case(rng, 4, 7, 1))
    with pytest.raises(ValueError, match="CUDA"):
        tfq.fabric_queue_update(q, qd, _t(np.zeros((4, 7))), *lanes)
    tops.fabric_queue_scan(q, qd, t)
    assert tfq.fabric_queue_step.launches == n0
