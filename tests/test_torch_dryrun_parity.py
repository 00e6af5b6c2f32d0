"""The port's dry-run held against the reference's on a dense smoke
architecture (granite-3-2b), at small shapes of each kind.

The reference lowers and compiles each cell (``lower_cell``) and reads
its loop-aware ``hlo_cost.analyze`` and XLA's memory analysis, once a
module in a child process on forced host devices (``_torch_dryrun``);
the port traces the same cell on ``meta`` under its counter.  Held:

* global flops on a 1 x 1 mesh, equal up to the gaps of known cause,
  which are pinned to their hand counts (``_torch_dryrun.known_gap``;
  ROADMAP queue C), within 1e-9 (float sums);
* argument bytes a device on a 2 x 2 mesh with FSDP, exactly (and on
  1 x 1);
* flops a device on the 2 x 2 mesh within ``DEVICE_TOL`` (1 %) after
  the known gaps.
"""

import pytest

from _torch_dryrun import (DEVICE_TOL, SHAPES, known_gap, port,
                           reference)
from repro_torch.configs.base import get_smoke_config

ARCH = "granite_3_2b"
KINDS = [s[0] for s in SHAPES]


@pytest.mark.parametrize("shape", KINDS)
def test_global_flops_1x1(shape):
    ref = reference(ARCH)[f"{shape}/1x1"]
    res, _, _ = port(ARCH, shape, "1x1")
    gap = known_gap(get_smoke_config(ARCH), shape, "1x1")
    assert res["flops"] + gap == pytest.approx(ref["flops"], rel=1e-9)


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
@pytest.mark.parametrize("shape", KINDS)
def test_argument_bytes_exact(shape, mesh):
    ref = reference(ARCH)[f"{shape}/{mesh}"]
    _, _, mem = port(ARCH, shape, mesh)
    assert mem["argument_size_in_bytes"] == ref["argument_size_in_bytes"]


@pytest.mark.parametrize("shape", KINDS)
def test_device_flops_2x2(shape):
    ref = reference(ARCH)[f"{shape}/2x2"]
    res, _, _ = port(ARCH, shape, "2x2")
    gap = known_gap(get_smoke_config(ARCH), shape, "2x2")
    assert res["flops"] + gap == pytest.approx(ref["flops"],
                                               rel=DEVICE_TOL)
