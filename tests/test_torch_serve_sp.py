"""Serving and scoring a sharded model under sequence parallelism
(``make_rules(mesh, fsdp=True, seq_parallel=True)``), the smoke configs
in float32 compute on ``(2, 2)`` (``tests/_torch_tp_serve.py``):
``LM.prefill`` and ``LM.score`` run the stack on each rank's block of
the prompt's positions, and the decode steps after the prefill run
their one position whole on every rank, against the reference's
jitted calls under the same rules on the same mesh of 4 forced host
devices (its decode step pads the one position inside its program):

- granite-34b, a prompt of 15 (blocks of 8, the last with 7 and a zero
  row), ``max_len`` 21: one kv head, so the cache splits over its
  slots, 11 a rank with the last block padded (the reference's jit
  cannot place that split, so its decode takes the cache whole at the
  boundary: ROADMAP queue C);
- falcon-mamba-7b, a prompt of 15: the conv and B7 run on the whole
  gathered prompt, each rank's state its channels;
- llama-3.2-vision-11b, a prompt of 16, every ``xgate`` 0.7: the image
  tokens whole, the gate applied to the rank's block;
- hubert-xlarge, ``LM.score`` of 15 frames, projected whole and cut to
  each rank's block.

The checks are ``test_torch_serve_tp.py``'s: every rank's logits
(prefill, then 6 teacher-forced decode steps) within 1e-5 of the
reference's, its greedy tokens equal where the reference's top-2 margin
exceeds 1e-4, ``launch.serve.generate``'s tokens, each cache shard
equal to its part of the reference's cache with its bytes
``launch.dryrun.device_bytes`` counts, and the world of one's logits
within 1e-5 of the sharded run's; every block of the prefill or
score took the rank's block of ``ceil(S / 2)`` positions; and a decode
step ran the collectives of granite-34b's plain tensor-parallel run.
"""

import numpy as np
import pytest

import _torch_tp_serve as S

CASES = [("granite_34b", 2, 2, 15, 21, True),
         ("falcon_mamba_7b", 2, 2, 15, 21, True),
         ("llama32_vision_11b", 2, 2, 16, 22, True),
         ("hubert_xlarge", 2, 2, 15, 0, True)]
DECODED = CASES[:3]
#: granite-34b's case without sequence parallelism
PLAIN = CASES[0][:5]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return S.runs(tmp_path_factory.mktemp("serve_sp"), CASES + [PLAIN])


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_logits_match_reference(runs, case):
    S.check_logits(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_residual_stream_is_the_rank_block(runs, case):
    S.check_residual(runs[1], case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_cache_shards_match_reference(runs, case):
    S.check_cache(*runs, case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_generate_on_the_sharded_model(runs, case):
    S.check_generate(*runs, case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_decode_runs_whole_on_every_rank(runs, case):
    """``LM.init_cache`` gives every rank the parts its sequence-split
    prefill fills (the plain tensor-parallel layout), and each decode
    step runs the same collectives on every rank."""
    _, ranks = runs
    k = S.key(case)
    assert all(bool(r[f"{k}/init_like_prefill"]) for r in ranks)
    calls = [r[f"{k}/calls"] for r in ranks]
    assert all(np.array_equal(c, calls[0]) for c in calls), calls
    assert len(set(calls[0].tolist())) == 1 and calls[0][0] > 0, calls


def test_decode_collectives_as_without_sp(runs):
    """A decode step after a sequence-split prefill runs the plain
    tensor-parallel step's collectives (its one position is whole on
    every rank), and the prefill's logits match the plain run's."""
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r[f"{S.key(CASES[0])}/calls"],
                                      r[f"{S.key(PLAIN)}/calls"])
    S.check_logits(ref, ranks, PLAIN)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_counted_prefill_and_decode_equal_meta_trace(runs, case):
    """A prefill (a score for an encoder) and a decode step on every
    rank under the cost counter: flops, bytes and collectives by kind
    equal to the dry-run's ``meta`` trace of rank 0 of the same cell."""
    S.check_counted(runs[1], case)
