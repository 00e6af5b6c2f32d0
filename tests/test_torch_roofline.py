"""The LM roofline of the port (``repro_torch.launch.roofline``): its
parameter and scan-state counts equal the reference's
(``benchmarks/roofline.py:45-104``) for all ten architectures, a
hand-made record's terms on the H100's data-sheet constants, and the
``≥`` mark of a collective term that lacks A.11d's collectives."""

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
    full = _rec(arch="qwen3_14b")
    part = _rec(collectives_incomplete="model axis and FSDP wait for "
                                       "ROADMAP A.11d")
    for name, rec in (("qwen3_14b--train_4k--pod", full),
                      ("granite_3_2b--train_4k--pod", part),
                      ("granite_3_2b--train_4k--multipod",
                       dict(part, mesh_kind="multipod"))):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "granite_3_2b--train_4k--pod.ops.json").write_text("{}")
    cells = R.load_cells("pod", dryrun_dir=str(tmp_path))
    assert [c["arch"] for c in cells] == ["granite_3_2b", "qwen3_14b"]
    rows = R.table(cells).splitlines()[2:]
    assert "| ≥ 125.00 |" in rows[0] and "≥" not in rows[1]
