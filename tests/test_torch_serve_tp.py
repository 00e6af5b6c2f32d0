"""Serving a sharded model, the dense and MoE families' smoke configs in
float32 compute (``tests/_torch_tp_serve.py``): ``LM.prefill`` and
``LM.decode_step`` of a model cut by ``shard_model`` on 4 gloo ranks
against the reference's jitted under its rules on the same ``(data,
model)`` meshes of 4 forced host devices, teacher-forced for 6 steps.

- granite-34b (K = 1) on ``(1, 4)`` with ``max_len`` 21: the kv
  weights split but the heads do not, so the cache splits over its
  slots, blocks of 6 with the last one padded (the reference's jit
  refuses to place such a cache by ``_cache_shardings``: ROADMAP queue
  C, ``test_reference_refuses_an_uneven_cache_split``);
- granite-3-2b (K = 2) on ``(2, 2)``, the cache split by kv heads, and
  on ``(1, 4)``, by slots;
- mixtral-8x22b's window-16 ring cache on ``(1, 4)``, split over its 16
  slots (``slot_pos`` whole on every rank), a prompt of 20 so the ring
  wraps, and the ``tp`` expert layout at decode shapes.

Every rank's logits within 1e-5 of the reference's, its greedy tokens
equal where the reference's top-2 margin exceeds 1e-4, the world of
one's logits within 1e-5 of the sharded run's, and each cache shard
equal to its part of the reference's cache, its bytes those
``launch.dryrun.device_bytes`` counts under ``_cache_spec``.
"""

import numpy as np
import pytest

import _torch_tp_serve as S

CASES = [("granite_34b", 1, 4, 12, 21), ("granite_3_2b", 2, 2, 12, 20),
         ("granite_3_2b", 1, 4, 12, 20), ("mixtral_8x22b", 1, 4, 20, 32)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return S.runs(tmp_path_factory.mktemp("serve_tp"), CASES)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_logits_match_reference(runs, case):
    S.check_logits(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_cache_shards_match_reference(runs, case):
    S.check_cache(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_generate_on_the_sharded_model(runs, case):
    S.check_generate(*runs, case)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_init_cache_builds_the_prefilled_parts(runs, case):
    """``LM.init_cache`` of the sharded model gives every rank the
    shapes and dtypes its prefill fills (a sequence split's padded
    block, a ring's whole ``slot_pos``)."""
    _, ranks = runs
    assert all(bool(r[f"{S.key(case)}/init_like_prefill"]) for r in ranks)


@pytest.mark.parametrize("case", CASES, ids=S.key)
def test_collectives_a_decode_step(runs, case):
    """Each decode step runs the same collectives, on every rank."""
    _, ranks = runs
    calls = [r[f"{S.key(case)}/calls"] for r in ranks]
    assert all(np.array_equal(c, calls[0]) for c in calls), calls
    assert len(set(calls[0].tolist())) == 1 and calls[0][0] > 0, calls


def test_reference_refuses_an_uneven_cache_split(runs):
    """The reference's ``_cache_shardings`` splits granite-34b's cache
    over its 21 slots on 4 devices, which its jit refuses (the dry-run
    only counts it); the cases the model axis divides place."""
    ref, _ = runs
    said = {c: str(ref[f"{S.key(c)}/placed"]) for c in CASES}
    assert "divisible by 4" in said[CASES[0]], said
    assert all(v == "" for c, v in said.items() if c != CASES[0]), said
