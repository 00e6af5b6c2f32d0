"""Training of the port past data parallelism, the two MoE layouts'
smoke configs in float32 compute (``tests/_torch_tp.py``): mixtral-8x22b
(``layout="tp"``: ``ff`` split inside every expert) on ``(2, 2)`` with
FSDP and ``(1, 4)``, and moonshot-v1-16b-a3b (``layout="ep"``: the
experts split) on ``(2, 2)`` with FSDP, ``psum``, on 4 gloo ranks
against the reference's step on the same meshes of 4 forced host
devices.

The reference's manual modes raise for both layouts under this JAX
(ROADMAP queue C), so the port's are held otherwise: ``(2, 2)`` ``ring``
against the reference's ``psum`` (the two agree in every reference run
that works, and the port takes the load-balance loss over the whole
data-parallel batch in every mode, so the mode changes only the
reduction), and ``(2, 2)`` ``aer_topk`` against the port's own
``(2, 1)`` ``aer_topk`` (a whole reference leaf is thresholded either
way).  Tolerances as in ``test_torch_train_tp.py``.
"""

import pytest

import _torch_tp as T

MIXTRAL, MOONSHOT = "mixtral_8x22b", "moonshot_v1_16b_a3b"
PSUM = [(MIXTRAL, 2, 2, True, "psum"), (MIXTRAL, 1, 4, True, "psum"),
        (MOONSHOT, 2, 2, True, "psum")]
RING = [(MIXTRAL, 2, 2, True, "ring"), (MOONSHOT, 2, 2, True, "ring")]
AER = [(MIXTRAL, 2, 2, True, "aer_topk"), (MOONSHOT, 2, 2, True, "aer_topk")]


def _on(case, d, m):
    return (case[0], d, m, case[3], case[4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    port = PSUM + RING + AER + [_on(c, 2, 1) for c in AER]
    return T.runs(tmp_path_factory.mktemp("tp"), PSUM, port)


@pytest.mark.parametrize("case", PSUM, ids=T.key)
def test_psum_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


@pytest.mark.parametrize("case", RING, ids=T.key)
def test_ring_matches_reference_psum(runs, case):
    ref, ranks = runs
    want = T.ref_want(ref, (*case[:4], "psum"))
    T.check_case(want, ranks, case)


@pytest.mark.parametrize("case", AER, ids=T.key)
def test_aer_topk_matches_data_only_mesh(runs, case):
    _, ranks = runs
    T.check_case(T.port_want(ranks, _on(case, 2, 1)), ranks, case)
