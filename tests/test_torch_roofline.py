"""The LM roofline of the port (``repro_torch.launch.roofline``): its
parameter and scan-state counts equal the reference's
(``benchmarks/roofline.py:45-104``) for all ten architectures, a
hand-made record's terms on the H100's data-sheet constants, the
collective term priced by where each group's ranks lie (NVLink within
a host of 8 cards, the NIC across hosts), and a record of a dry-run
that lacked the model axis's and FSDP's collectives refused."""

import importlib.util
import json
import pathlib

import pytest

from repro_torch.configs.base import ARCH_IDS
from repro_torch.launch import roofline as R

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_ref_roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_reference(arch):
    assert R._active_params(arch) == REF._active_params(arch)
    assert R._ssm_state_flops_per_token(arch) == \
        REF._ssm_state_flops_per_token(arch)


def test_constants_are_the_h100_data_sheet():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert (R.HOST_BW, R.HOST_CARDS) == (50e9, 8)


@pytest.mark.parametrize("ranks,rate", [
    (range(8), 450e9),                # one host: NVLink
    (range(8, 16), 450e9),            # the second host alone
    ((0, 2, 4, 6), 450e9),            # a strided group inside one host
    (range(16), 50e9),                # two hosts: the NIC
    ((0, 8), 50e9),                   # one card on each of two hosts
    (range(0, 256, 16), 50e9),        # a pod's data group
])
def test_link_rate_by_where_the_group_lies(ranks, rate):
    assert R.link_rate(ranks) == rate


def test_pod_groups_both_span_hosts():
    """On the 16 x 16 pod rank 0's data group (0, 16, ..., 240) and its
    model group (0 .. 15) both span hosts; on a (2, 4) mesh of one host
    both lie in it."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.compat import Mesh
    pod = make_production_mesh()
    assert pod.dp_group.ranks == tuple(range(0, 256, 16))
    assert pod.model_group.ranks == tuple(range(16))
    assert (pod.dp_group.axis, pod.model_group.axis) == ("dp", "model")
    assert R.link_rate(pod.dp_group.ranks) == R.link_rate(
        pod.model_group.ranks) == R.HOST_BW
    one = Mesh({"data": 2, "model": 4})
    assert one.dp_group.ranks == (0, 4) and one.model_group.ranks == (
        0, 1, 2, 3)
    assert R.link_rate(one.dp_group.ranks) == R.link_rate(
        one.model_group.ranks) == R.LINK_BW


def test_collective_term_sums_the_axes():
    """Each axis's bytes at its group's rate, summed."""
    rec = _rec(collective_bytes_total=1.5e9, collectives_by_axis={
        "model": {"bytes": 1e9, "count": 3, "ranks": list(range(8))},
        "dp": {"bytes": 5e8, "count": 2, "ranks": [0, 8, 16, 24]}})
    c = R.analyze_cell(rec)
    assert c["t_collective_s"] == pytest.approx(1e9 / 450e9 + 5e8 / 50e9)
    none = R.analyze_cell(_rec(collectives_by_axis={}))
    assert none["t_collective_s"] == 0.0


def _rec(**kw):
    rec = {"arch": "granite_3_2b", "shape": "train_4k", "kind": "train",
           "mesh_kind": "pod", "n_devices": 256, "flops": 989e12 * 0.5,
           "bytes_accessed": 3.35e12 * 0.25,
           "collective_bytes_total": 450e9 * 0.125}
    rec.update(kw)
    return rec


def test_analyze_cell_terms():
    c = R.analyze_cell(_rec())
    assert c["t_compute_s"] == pytest.approx(0.5)
    assert c["t_memory_s"] == pytest.approx(0.25)
    assert c["t_collective_s"] == pytest.approx(0.125)
    assert (c["dominant"], c["bound_time_s"]) == ("compute",
                                                  pytest.approx(0.5))
    assert c["roofline_fraction"] == pytest.approx(1.0)
    model = 6 * R._active_params("granite_3_2b") * 256 * 4096
    assert c["model_flops_global"] == model
    assert c["useful_ratio"] == pytest.approx(model / (989e12 * 0.5 * 256))
    assert "useful_ratio_ssm_adjusted" not in c
    m = R.analyze_cell(_rec(arch="falcon_mamba_7b",
                            bytes_accessed=3.35e12))
    assert m["dominant"] == "memory" and m["roofline_fraction"] == \
        pytest.approx(0.5)
    assert m["useful_ratio_ssm_adjusted"] > m["useful_ratio"]
    d = R.analyze_cell(_rec(kind="decode", shape="decode_32k"))
    assert "useful_ratio" not in d


def test_incomplete_collectives_print_as_lower_bound(tmp_path):
    """No row prints a lower bound any more: the dry-run traces every
    collective of a rank.  A record of an older dry-run that says its
    collectives are incomplete is refused, not printed with ``≥``."""
    full = _rec(arch="qwen3_14b", collectives_by_axis={
        "model": {"bytes": 450e9 * 0.125, "count": 1,
                  "ranks": list(range(8))}})
    part = _rec(collectives_incomplete="model axis and FSDP wait for "
                                       "ROADMAP A.11d")
    for name, rec in (("qwen3_14b--train_4k--pod", full),
                      ("granite_3_2b--train_4k--pod", part),
                      ("granite_3_2b--train_4k--multipod",
                       dict(part, mesh_kind="multipod"))):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "granite_3_2b--train_4k--pod.ops.json").write_text("{}")
    with pytest.raises(ValueError, match="trace the cell again"):
        R.load_cells("pod", dryrun_dir=str(tmp_path))
    (tmp_path / "granite_3_2b--train_4k--pod.json").write_text(
        json.dumps(_rec()))
    cells = R.load_cells("pod", dryrun_dir=str(tmp_path))
    assert [c["arch"] for c in cells] == ["granite_3_2b", "qwen3_14b"]
    rows = R.table(cells).splitlines()[2:]
    assert "| 125.00 |" in rows[0] and "| 125.00 |" in rows[1]
    assert "≥" not in R.table(cells)
