"""The port's dry-run held against the reference's on a Mamba smoke
architecture (falcon-mamba-7b), at small shapes of each kind.  Here the
known gaps are large: the reference's conv and scan products are dots
and convolutions in its HLO (and ``hlo_cost`` counts the conv's weight
gradient 2·k·d_in² x its input), where the port runs elementwise
products and B7 with its backward, which carry no flops.

The reference lowers and compiles each cell (``lower_cell``) and reads
its loop-aware ``hlo_cost.analyze`` and XLA's memory analysis, once a
module in a child process on forced host devices (``_torch_dryrun``);
the port traces the same cell on ``meta`` under its counter.  Held:

* global flops on a 1 x 1 mesh, equal up to the gaps of known cause,
  which are pinned to their hand counts (``_torch_dryrun.known_gap``;
  ROADMAP queue C), within 1e-9 (float sums);
* argument bytes a device on a 2 x 2 mesh with FSDP, exactly (and on
  1 x 1);
* a decode step's all-reduce bytes on the 2 x 2 mesh, 3,456 B on both
  sides;
* flops a device on the 2 x 2 mesh within ``DEVICE_TOL`` (1 %) after
  the known gaps (the port's are rank 0's traced program).
"""

import pytest

from _torch_dryrun import (DEVICE_TOL, SHAPES, known_gap, port,
                           reference)
from repro_torch.configs.base import get_smoke_config

ARCH = "falcon_mamba_7b"
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


def test_decode_all_reduce_bytes_2x2():
    """What the two programs share of their collectives: a decode step's
    all-reduces on the 2 x 2 mesh, 3,456 B a device on both sides (the
    rank's trace counts the port's; the rest of the two tallies differ
    by design, ROADMAP queue C)."""
    ref = reference(ARCH)["decode_s/2x2"]["collectives"]
    res, _, _ = port(ARCH, "decode_s", "2x2")
    assert res["collectives"]["all-reduce"] == ref["all-reduce"] == 3456
    assert res["collectives"]["all-reduce_count"] == \
        ref["all-reduce_count"] == 5
