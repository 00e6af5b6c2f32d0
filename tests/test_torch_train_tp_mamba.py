"""Training of the port past data parallelism, falcon-mamba-7b's smoke
config in float32 compute (``tests/_torch_tp.py``): ``(2, 2)`` with
FSDP, ``psum`` and ``aer_topk``, and ``(1, 4)``, ``psum``, on 4 gloo
ranks against the reference's step on the same meshes of 4 forced host
devices.  Over the model axis each rank holds its block of ``d_inner``
(32 of 128 channels at ``(1, 4)``): ``in_proj``'s shard takes the same
channels of ``x`` and of ``z``, ``x_proj``'s partial products are summed
over the model group, and the scan and its gradient run on the rank's
channels.  Tolerances as in ``test_torch_train_tp.py``; ``aer_topk``
gathers each model-split gradient whole before it thresholds, so its
wire words are the reference's.
"""

import pytest

import _torch_tp as T

ARCH = "falcon_mamba_7b"
CASES = [(ARCH, 2, 2, True, "psum"), (ARCH, 2, 2, True, "aer_topk"),
         (ARCH, 1, 4, True, "psum")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.runs(tmp_path_factory.mktemp("tp"), CASES, CASES)


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_case_matches_reference(runs, case):
    ref, ranks = runs
    T.check_case(T.ref_want(ref, case), ranks, case)


@pytest.mark.parametrize("case", CASES, ids=T.key)
def test_counted_step_equals_meta_trace(runs, case):
    """One more step on every rank under the cost counter: its flops,
    bytes and collectives by kind equal to the dry-run's ``meta`` trace
    of rank 0 of the same cell."""
    T.check_counted_step(runs[1], case)
