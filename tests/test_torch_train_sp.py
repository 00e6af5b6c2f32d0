"""Sequence parallelism in the port's sharded training step: rules from
``make_rules(mesh, seq_parallel=True)``, the residual stream between
the blocks each model-group rank's block of positions
(``parallel.tensor_parallel``), the smoke configs in float32 compute on
4 gloo ranks against the reference's jitted step under the same rules
on the same ``(data, model)`` meshes of 4 forced host devices, from the
reference's initial parameters on the same ``SyntheticLM`` batches
(``tests/_torch_tp.py``):

- granite-3-2b on ``(2, 2)`` with FSDP under ``psum`` and ``aer_topk``,
  and without FSDP under ``ring``;
- falcon-mamba-7b on ``(2, 2)`` with FSDP, ``psum``; and at 15
  positions (the model axis does not divide them: the last block holds
  7 and a zero row), held against the port's own step without
  sequence parallelism, which is held against the reference's.  At 15
  positions one entry of 32,768 of ``embed.table``, (418, 54), lies
  1.3e-4 from the reference's sequence-parallel step: its gradient is
  near zero, AdamW scales the rounding noise up to a step, and the
  reference's own steps with and without sequence parallelism differ
  there by 7.6e-5, while the port's two are bit-equal.

The checks are ``_torch_tp.check_case``'s, at its tolerances: every
rank's losses within 1e-5 and gradient norms within 1e-5 relative of
the comparator's, its gathered parameters within 1e-4 (``aer_topk``:
``_torch_dp.AER_PARAM_TOL``), and the leaves no spec splits over the
model axis (the norm scales) bit-equal across each model group.  Each
block's residual stream is the rank's block of ``ceil(S / tp)``
positions.  The MoE, hybrid and vision families are in
``test_torch_train_sp_hybrid.py``.
"""

import pytest

import _torch_tp as T

GRANITE, FALCON = "granite_3_2b", "falcon_mamba_7b"
REF = [(GRANITE, 2, 2, True, "psum", True),
       (GRANITE, 2, 2, True, "aer_topk", True),
       (GRANITE, 2, 2, False, "ring", True),
       (FALCON, 2, 2, True, "psum", True),
       (FALCON, 2, 2, True, "psum", False, 15)]
UNEVEN = (FALCON, 2, 2, True, "psum", True, 15)
CASES = REF + [UNEVEN]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.runs(tmp_path_factory.mktemp("sp"), REF, CASES)


@pytest.mark.parametrize("case", REF, ids=T.key)
def test_case_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


def test_uneven_split_matches_the_whole_stream(runs):
    _, ranks = runs
    T.check_case(T.port_want(ranks, REF[-1]), ranks, UNEVEN)


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_residual_stream_is_the_rank_block(runs, case):
    """Every block of every rank took ``ceil(S / tp)`` positions of
    the residual stream under sequence parallelism, not the whole
    sequence (which it takes without)."""
    _, ranks = runs
    arch, d, m, fsdp, mode, sp, seq = T.parts(case)
    on = [r for r in ranks if f"{T.key(case)}/resid" in r]
    assert len(on) == d * m
    want = -(-seq // m) if sp else seq
    for r in on:
        assert r[f"{T.key(case)}/resid"].tolist() == [want], case


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_counted_step_equals_meta_trace(runs, case):
    """One more step on every rank under the cost counter: its flops,
    bytes and collectives by kind equal to the dry-run's ``meta`` trace
    of rank 0 of the same cell."""
    T.check_counted_step(runs[1], case)
