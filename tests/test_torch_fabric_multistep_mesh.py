"""The multi-step kernel's plain runs on ``device="cpu"``: the 14x14 mesh multicast case (364
links, K = 3): its claims (more lanes than a block has threads, its
tier of shared memory, stalls) and its column checks
(``_torch_multistep``; split from ``test_torch_fabric_multistep.py`` so
that no file takes more than ~400 s on one worker)."""

import pytest

import _torch_multistep as M


@pytest.mark.parametrize("name", M.MESH)
def test_card_cases_reach_the_paths_they_claim(name):
    """As ``test_torch_fabric_multistep.py``'s test, on the mesh case."""
    M.check_case_claims(name)


@pytest.mark.parametrize("name", M.MESH)
def test_plain_runs_keep_columns_past_n_ins_empty(name):
    """As ``test_torch_fabric_multistep_columns.py``'s test, on the mesh
    case."""
    M.check_columns(name)
