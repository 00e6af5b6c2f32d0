"""The multi-step kernel's plain runs on ``device="cpu"``: the column checks of the two widest
rings (the ring-16 whose q_time plane just fits shared memory, and
ring-40, two warps of links)
(``_torch_multistep``; split from ``test_torch_fabric_multistep.py`` so
that no file takes more than ~400 s on one worker)."""

import pytest

import _torch_multistep as M
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", M.WIDE)
def test_plain_runs_keep_columns_past_n_ins_empty(name):
    """As ``test_torch_fabric_multistep_columns.py``'s test, on the
    widest rings."""
    M.check_columns(name)
