"""Serving and scoring a sharded model, the Mamba, hybrid, vision and
encoder smoke configs in float32 compute on ``(2, 2)`` with FSDP
(``tests/_torch_tp_serve.py``), against the reference's jitted under
its rules on the same mesh of 4 forced host devices:

- falcon-mamba-7b: each rank's state is its 64 of the 128 ``d_inner``
  channels (``h`` and ``conv``), the prefill scan runs on them;
- jamba-v0.1-52b: ``mamba_ffn``, ``mamba_moe`` (the ``ep`` expert
  layout at decode shapes) and attention with its cache split by kv
  heads;
- llama-3.2-vision-11b with every ``xgate`` 0.7: the image cache split
  by kv heads, read by every decode step; and a variant with 1 kv head
  and 7 image tokens, whose image cache splits over its tokens in
  blocks of 4, the last one padded and masked, its softmax combined
  over the model group (the reference's jit cannot place that cache and
  takes it whole at the decode's boundary, ``_torch_tp_serve``);
- hubert-xlarge: ``LM.score``.

The checks are ``test_torch_serve_tp.py``'s.
"""

import numpy as np
import pytest

import _torch_tp_serve as S

CASES = [("falcon_mamba_7b", 2, 2, 12, 20), ("jamba_v01_52b", 2, 2, 12, 20),
         ("llama32_vision_11b", 2, 2, 12, 20), ("hubert_xlarge", 2, 2, 12, 0),
         ("llama32_vision_11b+n_kv_heads=1+n_img_tokens=7", 2, 2, 12, 20)]
DECODED = [c for c in CASES if c[4]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return S.runs(tmp_path_factory.mktemp("serve_tp"), CASES)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_logits_match_reference(runs, case):
    S.check_logits(*runs, case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_cache_shards_match_reference(runs, case):
    S.check_cache(*runs, case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_generate_on_the_sharded_model(runs, case):
    S.check_generate(*runs, case)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_init_cache_builds_the_prefilled_parts(runs, case):
    """``LM.init_cache`` of the sharded model gives every rank the
    shapes and dtypes its prefill fills; an image model's
    ``precompute_cross_cache`` gives its prefill's image cache."""
    _, ranks = runs
    k = S.key(case)
    assert all(bool(r[f"{k}/init_like_prefill"]) for r in ranks)
    if case[0].startswith("llama32_vision_11b"):
        assert all(float(r[f"{k}/precompute_gap"]) == 0.0 for r in ranks)


@pytest.mark.parametrize("case", DECODED, ids=S.key)
def test_collectives_a_decode_step(runs, case):
    """Each decode step runs the same collectives, on every rank."""
    _, ranks = runs
    calls = [r[f"{S.key(case)}/calls"] for r in ranks]
    assert all(np.array_equal(c, calls[0]) for c in calls), calls
    assert len(set(calls[0].tolist())) == 1 and calls[0][0] > 0, calls


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_counted_prefill_and_decode_equal_meta_trace(runs, case):
    """A prefill (a score for an encoder) and a decode step on every
    rank under the cost counter: flops, bytes and collectives by kind
    equal to the dry-run's ``meta`` trace of rank 0 of the same cell."""
    S.check_counted(runs[1], case)
