"""The multi-step kernel's plain runs on ``device="cpu"``: after every step of each case's plain run the columns at or past
``n_ins`` hold ``BIG_NS`` and the windowed scan the kernel runs gives
``ref.fabric_queue_scan``'s results
(``_torch_multistep``; split from ``test_torch_fabric_multistep.py`` so
that no file takes more than ~400 s on one worker)."""

import pytest

import _torch_multistep as M
from _torch_cases import multistep_cases


@pytest.mark.parametrize("name", [c[0] for c in multistep_cases()
                                  if c[0] not in M.WIDE + M.MESH])
def test_plain_runs_keep_columns_past_n_ins_empty(name):
    """After every step of the case's plain run, the columns at or past
    ``n_ins[q]`` hold ``BIG_NS``, and the windowed scan gives
    ``ref.fabric_queue_scan``'s count, minimum and next release on every
    row, and its popped slot wherever the count is > 0."""
    M.check_columns(name)
