"""Training of the port past data parallelism for the block kinds past
``attn_ffn``, ``attn_moe`` and ``mamba`` (``tests/_torch_tp.py``), the
smoke configs in float32 compute on ``(2, 2)`` with FSDP, on 4 gloo
ranks against the reference's step on the same mesh of 4 forced host
devices:

- jamba-v0.1-52b: ``mamba_ffn``, ``mamba_moe`` (the ``ep`` expert
  layout) and its attention layer, under ``psum``, and under ``ring``
  against the reference's ``psum``;
- llama-3.2-vision-11b, every ``xgate`` starting at 0.7: the
  cross-attention's keys and values from the frontend's image tokens,
  split by kv heads, the gate whole on every rank (its gradient the
  same on every rank of a model group, so it stays bit-equal there);
  ``psum``, and ``aer_topk`` against the port's own ``(2, 1)`` mesh
  (the data axis's size changes ``aer_topk``'s result, the model axis
  and FSDP do not);
- hubert-xlarge, the encoder, its audio frames through the frontend,
  under ``psum`` and ``ring``.

The reference's manual modes raise for jamba and llama-vision under
this JAX (ROADMAP queue C), hence their comparators.  The checks are
``_torch_tp.check_case``'s: every rank's losses within 1e-5 and
gradient norms within 1e-5 relative of the comparator's, its gathered
parameters within 1e-4 (``aer_topk``: 2 lr a step), and the leaves no
spec splits over the model axis (``xgate`` among them) bit-equal across
each model group.
"""

import pytest

import _torch_tp as T

JAMBA, LLAMA, HUBERT = "jamba_v01_52b", "llama32_vision_11b", "hubert_xlarge"
REF = [(JAMBA, 2, 2, True, "psum"), (LLAMA, 2, 2, True, "psum"),
       (HUBERT, 2, 2, True, "psum"), (HUBERT, 2, 2, True, "ring")]
MOE_RING = (JAMBA, 2, 2, True, "ring")
VISION_AER, VISION_AER_DATA = (LLAMA, 2, 2, True, "aer_topk"), \
    (LLAMA, 2, 1, True, "aer_topk")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.runs(tmp_path_factory.mktemp("tp"), REF,
                  REF + [MOE_RING, VISION_AER, VISION_AER_DATA])


@pytest.mark.parametrize("case", REF, ids=T.key)
def test_case_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


def test_moe_ring_matches_reference_psum(runs):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, (*MOE_RING[:4], "psum")), ranks, MOE_RING)


def test_vision_aer_topk_matches_data_only_mesh(runs):
    _, ranks = runs
    T.check_case(T.port_want(ranks, VISION_AER_DATA), ranks, VISION_AER)


def test_xgate_is_whole_and_trained(runs):
    """Every rank of llama's run keeps the whole ``xgate`` of each
    cross-attention layer, moved off its start by the steps."""
    _, ranks = runs
    k = T.key(REF[1])
    names = [n for n in ranks[0] if n.startswith(f"{k}/whole/")
             and n.endswith("xgate")]
    assert names, sorted(ranks[0])[:8]
    for r in ranks:
        for n in names:
            assert r[n].shape == () and float(r[n]) != T.XGATE, (n, r[n])
