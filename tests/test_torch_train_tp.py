"""Training of the port past data parallelism, granite-3-2b's smoke
config in float32 compute: 4 gloo ranks of the port against the
reference's step on the same ``(data, model)`` meshes of 4 forced host
devices, from the reference's initial parameters on the same
``SyntheticLM`` batches (``tests/_torch_tp.py``).

- ``(2, 2)`` with FSDP, ``psum`` and ``aer_topk``; ``(1, 4)``, ``psum``
  (4 query heads, 2 kv heads: the kv weights split over the model axis
  but the kv heads do not, so every rank gathers k and v); ``(4, 1)``
  with FSDP, ``ring`` (the manual region: FSDP leaves whole over the
  data group for the step); a variant with 3 query heads and 1 kv head
  on ``(2, 2)`` with FSDP, ``psum`` (the query heads do not split over
  the model axis: every rank gathers q, runs all 3 heads and keeps its
  block of the output's columns for ``wo``); and ``(pod, data, model)
  = (2, 2, 1)`` with FSDP, ``psum``: FSDP splits over ``"data"`` alone,
  each pod holding the whole leaf, so a leaf's gradient comes out of
  its gather's reduce-scatter summed within the pod and an all-reduce
  over the pod group completes it (``Mesh.group_along``).  The losses of 3 steps on every rank within
  1e-5 of the reference's, the gathered parameters within 1e-4
  (``aer_topk``: 6e-3, ``_torch_dp.AER_PARAM_TOL``), the wire words
  within 1e-3, and the leaves no spec splits over the model axis
  bit-equal across the ranks of each model group.  Measured: losses
  within 1.5e-6 of the reference's.
- One more step on every rank under the cost counter: its flops, bytes
  and collectives by kind (counts and bytes) equal to the dry-run's
  ``meta`` trace of rank 0 of the same cell
  (``_torch_tp.check_counted_step``).
- A checkpoint round trip: the ``(2, 2)`` FSDP state saved whole,
  restored on ``(2, 2)`` and on a world of one, and that one's saved
  state restored on ``(2, 2)`` again, every leaf bit-equal; a save of
  the shards without their shardings is refused.

The Mamba and MoE families are in ``test_torch_train_tp_mamba.py`` and
``test_torch_train_tp_moe.py``.
"""

import numpy as np
import pytest

import _torch_tp as T

ARCH = "granite_3_2b"
CASES = [(ARCH, 2, 2, True, "psum"), (ARCH, 2, 2, True, "aer_topk"),
         (ARCH, 1, 4, True, "psum"), (ARCH, 4, 1, True, "ring"),
         (f"{ARCH}+n_heads=3+n_kv_heads=1", 2, 2, True, "psum"),
         (ARCH, (2, 2), 1, True, "psum")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return T.runs(tmp, CASES, CASES, ckpt=T.key(CASES[0]))


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_case_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


def test_checkpoint_round_trip_is_bit_equal(runs):
    _, ranks = runs
    assert all(bool(r["ckpt/mesh"]) and bool(r["ckpt/back"]) and
               bool(r["ckpt/refused"]) for r in ranks), \
        [{k: bool(v) for k, v in r.items() if k.startswith("ckpt/")}
         for r in ranks]
    assert bool(ranks[0]["ckpt/one"])
    assert not any("ckpt/one" in r for r in ranks[1:])
    assert np.all([r[f"{T.key(CASES[0])}/loss"] for r in ranks])


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_counted_step_equals_meta_trace(runs, case):
    T.check_counted_step(runs[1], case)
