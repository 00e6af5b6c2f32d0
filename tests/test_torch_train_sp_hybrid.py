"""Sequence parallelism in the port's sharded training step for the MoE,
hybrid and cross-attention blocks (``tests/_torch_tp.py``; the dense
and Mamba families are in ``test_torch_train_sp.py``), the smoke
configs in float32 compute on 4 gloo ranks against the reference's
jitted step under ``make_rules(mesh, seq_parallel=True)`` on the same
meshes of 4 forced host devices, ``psum``:

- mixtral-8x22b (the ``tp`` expert layout) on ``(1, 4)``, 18 positions
  on 4 ranks (blocks of 5, the last with 3 and two zero rows): the
  router and the capacity dispatch run on the 18 real positions of each
  row, gathered on every rank;
- jamba-v0.1-52b on ``(2, 2)`` with FSDP: ``mamba_ffn``, ``mamba_moe``
  (the ``ep`` layout) and attention;
- llama-3.2-vision-11b on ``(2, 2)`` with FSDP, every ``xgate`` 0.7:
  cross-attention over the whole image tokens, the gate applied to the
  rank's block of positions through *f*.

The checks are ``_torch_tp.check_case``'s (losses, which hold the MoE
load-balance and z losses, within 1e-5; gradient norms within 1e-5
relative; parameters within 1e-4; the leaves no spec splits over the
model axis, the router and ``xgate`` among them, bit-equal across each
model group), and each block's residual stream is the rank's block of
positions.
"""

import pytest

import _torch_tp as T

CASES = [("mixtral_8x22b", 1, 4, True, "psum", True, 18),
         ("jamba_v01_52b", 2, 2, True, "psum", True),
         ("llama32_vision_11b", 2, 2, True, "psum", True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.runs(tmp_path_factory.mktemp("sp"), CASES, CASES)


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_case_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_residual_stream_is_the_rank_block(runs, case):
    """Every block of every rank took ``ceil(S / tp)`` positions of
    the residual stream, not the whole sequence."""
    _, ranks = runs
    arch, d, m, fsdp, mode, sp, seq = T.parts(case)
    on = [r for r in ranks if f"{T.key(case)}/resid" in r]
    assert len(on) == d * m
    for r in on:
        assert r[f"{T.key(case)}/resid"].tolist() == [-(-seq // m)], case
