"""The pod-scale tools of the port on the CPU: the shape sets and
``input_specs`` against the reference's, the production mesh, the
FLOP / byte / collective counter on hand-computed cases, the LM stack
traced on ``meta`` (a smoke train step counted on the CPU and on meta
alike; every smoke arch and kind traced with no host read), the dry-run
CLI, and the fabric kernels refusing ``meta``."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as RB
from repro_torch.configs import base as B
from repro_torch.core import sparse_collectives as sc
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ssk
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM, build_model
from repro_torch.parallel import compat
from repro_torch.runtime import train_loop as tl

SMALL = {"train": B.ShapeConfig("train_s", 32, 4, "train"),
         "prefill": B.ShapeConfig("prefill_s", 64, 2, "prefill"),
         "decode": B.ShapeConfig("decode_s", 64, 4, "decode")}


def _smoke(arch):
    s = B.get_smoke_config(arch)
    return {f: getattr(s, f) for f in s.__dataclass_fields__}


@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_shapes_and_input_specs_match_reference(arch):
    """``shapes_for`` names the reference's shapes, and ``input_specs``
    its keys, shapes and dtypes, for every arch x shape (full
    configs); the tensors lie on ``meta``."""
    cfg, rcfg = B.get_config(arch), RB.get_config(arch)
    assert [s.name for s in B.shapes_for(cfg)] == \
        [s.name for s in RB.shapes_for(rcfg)]
    for s in B.shapes_for(cfg):
        rs = RB.ALL_SHAPES[s.name]
        assert (s.seq_len, s.global_batch, s.kind) == \
            (rs.seq_len, rs.global_batch, rs.kind)
        got, want = B.input_specs(cfg, s), RB.input_specs(rcfg, rs)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == \
                str(np.dtype(want[k].dtype))


def test_production_mesh_is_abstract():
    pod, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.axis_names == ("pod", "data", "model")
    assert tuple(multi.shape.values()) == (2, 16, 16)
    assert pod.groups is None and multi.groups is None
    assert pod.dp_group == compat.RecordingGroup(16)
    assert multi.dp_group == compat.RecordingGroup(32)
    assert not torch.distributed.is_initialized()


def test_counter_products_and_bytes():
    """2·M·N·K a product; operands plus result a non-view operator; a
    view moves nothing; an in-place add charges its other operand and a
    result up to that size."""
    x, w = torch.ones(4, 8), torch.ones(8, 16)
    with cost.Counter() as c:
        x @ w
    assert c.flops == 2 * 4 * 8 * 16
    assert c.bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    a, b = torch.ones(2, 3, 4), torch.ones(2, 4, 5)
    with cost.Counter() as c:
        torch.bmm(a, b)
        a.view(6, 4).t()
    assert c.flops == 2 * 2 * 3 * 5 * 4
    assert c.bytes == 4 * (24 + 40 + 30)
    y, z = torch.ones(3, 5), torch.ones(3, 5)
    with cost.Counter() as c:
        y.add_(z)
    assert (c.flops, c.bytes) == (0, 4 * 15 * 2)
    with cost.Counter() as c:
        F.linear(x, w.t())                      # addmm-free linear
    assert c.flops == 2 * 4 * 8 * 16
    res = cost.analyze(torch.matmul, x, w)
    assert set(cost.COST_KEYS) <= set(res) and res["flops"] == c.flops
    assert res["unknown_trip_count_loops"] == 0
    assert torch.equal(res["value"], x @ w)


def test_counter_convolution_and_peak():
    """A convolution counts 2 x output x kernel elements a output
    channel; the peak of live bytes follows temporaries."""
    x, w = torch.ones(1, 4, 10), torch.ones(6, 4, 3)
    with cost.Counter() as c:
        F.conv1d(x, w)
    assert c.flops == 2 * (1 * 6 * 8) * (4 * 3)
    with cost.Counter() as c:
        t = torch.ones(1000) * 2     # ones and t: 8000 B live at once
        u = t + 1                    # t and u: 8000 B
        del t, u
        v = torch.ones(10) * 2       # v alone stays: 40 B
    assert c.peak_live == 8000 and c.live == 40
    del v


def test_counter_inference_mode_decomposes():
    """Under inference mode composite operators arrive whole; the
    counter counts what they decompose into, as with autograd on."""
    a, w = torch.ones(2, 3, 4), torch.ones(4, 5)
    counts = []
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), cost.Counter() as c:
            a @ w
            torch.einsum("bij,jk->bik", a, w)
        counts.append((c.flops, c.bytes))
    assert counts[0] == counts[1] == (2 * 2 * (2 * 3 * 5 * 4),
                                      counts[0][1])


def test_kernel_wrappers_declare_bytes():
    """B5, B6 and B7 (and its backward) report their bytes and no flops,
    and hide the plain version's operators, on the CPU as on meta; B7's
    are ``scan_bound``'s, the bytes chip_smoke bounds it by."""
    g = torch.Generator().manual_seed(0)
    for dev in ("cpu", "meta"):
        x = torch.randn(8, 1024, generator=g).to(dev)
        tau = torch.full((8,), 0.5).to(dev)
        with cost.Counter() as c:
            ev = ops.aer_encode(x, tau, 32)
            ops.aer_decode(ev[0], ev[1], 1024)
        enc = 4 * (8 * 1024 + 8 + 2 * 8 * 32 + 2 * 8)
        dec = 4 * (2 * 8 * 32 + 8 * 1024)
        assert c.kernels == {"aer_encode": {"launches": 1, "bytes": enc},
                             "aer_decode": {"launches": 1, "bytes": dec}}
        assert (c.flops, c.bytes, sum(c.ops.values())) == (0, enc + dec, 2)
        args = [torch.randn(s, generator=g).to(dev).requires_grad_()
                for s in ((2, 8, 6), (2, 8, 6), (2, 8, 3), (2, 8, 3),
                          (6, 3))]
        with cost.Counter() as c:
            y, _ = ops.selective_scan(*args)
            y.sum().backward()
        assert c.kernels["selective_scan"]["bytes"] == \
            ssk.scan_bound(2, 8, 6, 3)["bytes"]
        # autograd hands the unused h_final a zero gradient, which the
        # backward reads
        assert c.kernels["selective_scan_bwd"]["bytes"] == \
            ssk.scan_bwd_bound(2, 8, 6, 3, dh_final=True)["bytes"]


def test_recorded_collectives_on_an_abstract_mesh():
    """On a ``RecordingGroup`` the collectives move nothing and record
    their kind and result bytes; without a counter they refuse."""
    grp = compat.RecordingGroup(4)
    x = torch.ones(64, 32, device="meta")
    with cost.Counter() as c:
        sc.dense_allreduce(x, grp)
        sc.aer_allreduce(torch.ones(4096), sc.AerState.init(
            torch.ones(4096)), grp, frac=0.05, budget=16)
    coll = c.result()["collectives"]
    assert coll["all-reduce"] == 64 * 32 * 4
    assert coll["all-gather"] == 2 * (4 * 4 * 16 * 4)
    assert (coll["all-reduce_count"], coll["all-gather_count"]) == (1, 2)
    with cost.Counter() as c:
        sc.dense_allreduce(x, grp, schedule="ring")
    assert c.result()["collectives"]["collective-permute_count"] == 6
    with pytest.raises(RuntimeError, match="Counter"):
        compat.all_reduce(x, grp)


def test_per_device_division_by_tags():
    """A counter over a mesh divides an operator by the mesh axes its
    operands are tagged with (the union); untagged work counts whole."""
    x, w = torch.ones(8, 16, device="meta"), torch.ones(16, 32,
                                                        device="meta")
    with cost.Counter({"data": 2, "model": 4}) as c:
        c.tag(x, {"data"})
        c.tag(w, {"model"})
        y = x @ w
        y + 1
        torch.ones(4, 4, device="meta") @ torch.ones(4, 4, device="meta")
    assert c.flops == 2 * 8 * 16 * 32 / 8 + 2 * 4 * 4 * 4
    assert c.axes_of([y]) == {"data", "model"}


@pytest.mark.parametrize("arch", ["granite_3_2b", "falcon_mamba_7b",
                                  "mixtral_8x22b"])
def test_smoke_train_step_counted_on_cpu_equals_meta(arch):
    """The same smoke train step, counted on the CPU (which computes)
    and on meta (which does not): every count equal."""
    cfg = B.get_smoke_config(arch)
    got = {}
    for dev in ("cpu", "meta"):
        model = build_model(cfg, seed=0, device=dev)
        state = tl.init_state(model, B.RunConfig())
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in B.input_specs(cfg, SMALL["train"]).items()}
        counter = cost.Counter()
        dryrun.trace_step(model, "train", batch, B.RunConfig(),
                          counter=counter, state=state)
        res = counter.result()
        got[dev] = {k: res[k] for k in ("flops", "bytes_accessed",
                                        "peak_live_bytes", "op_counts",
                                        "kernels")}
        assert res["flops"] > 0
    assert got["cpu"] == got["meta"]


@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_every_kind_traces_on_meta(arch, tmp_path):
    """``--all``-style: each kind of a smoke arch traced on meta over a
    2 x 2 abstract mesh (a host read would raise there), its record
    written with the reference's keys, no record saying its collectives
    are incomplete, and the model axis's collectives present (over
    ranks 0 and 1)."""
    cfg = B.get_smoke_config(arch)
    mesh = compat.Mesh({"data": 2, "model": 2})
    kinds = ["train", "prefill"] + (["decode"] if cfg.causal else [])
    for kind in kinds:
        run = B.RunConfig(dp_reduce="aer_topk" if kind == "train" else
                          "psum")
        rec = dryrun.run_cell(arch, SMALL[kind], "pod", run, _smoke(arch),
                              out_dir=str(tmp_path), mesh=mesh)
        assert set(dryrun.RECORD_KEYS) <= set(rec)
        assert set(rec["memory"]) == set(dryrun.MEMORY_KEYS)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["unknown_trip_count_loops"] == 0
        # rank 0's own program: its model axis's collectives are traced
        assert "collectives_incomplete" not in rec
        model = rec["collectives_by_axis"]["model"]
        assert model["count"] > 0 and model["bytes"] > 0
        assert model["ranks"] == [0, 1]
        if kind == "train":
            assert rec["collectives"]["all-gather_count"] > 0
        name = f"{arch}--{SMALL[kind].name}--pod"
        with open(tmp_path / f"{name}.json") as f:
            assert json.load(f)["counter"] == dryrun.COUNTER
        assert (tmp_path / f"{name}.ops.json").exists()


def test_cli_full_width_cells(tmp_path, capsys):
    """The CLI at full width: a decode cell on both production meshes;
    a skipped cell fails the run with exit 1."""
    dryrun.main(["--arch", "falcon_mamba_7b", "--shape", "decode_32k",
                 "--mesh", "both", "--out-dir", str(tmp_path)])
    recs = {p.name for p in tmp_path.glob("*.json")}
    assert {"falcon_mamba_7b--decode_32k--pod.json",
            "falcon_mamba_7b--decode_32k--multipod.json"} <= recs
    with open(tmp_path / "falcon_mamba_7b--decode_32k--multipod.json") as f:
        rec = json.load(f)
    assert rec["n_devices"] == 512 and rec["mesh"] == {"pod": 2, "data": 16,
                                                       "model": 16}
    assert "ALL CELLS OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k",
                     "--out-dir", str(tmp_path)])
    assert e.value.code == 1


def test_meta_is_reached_only_when_named(monkeypatch):
    """``meta`` builds an LM without drawing (no generator is made) and
    is never the default: without CUDA ``device=None`` still raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = B.get_smoke_config("jamba_v01_52b")
    made = []
    monkeypatch.setattr(torch, "Generator",
                        lambda *a, **k: made.append(1))
    model = build_model(cfg, device="meta")
    assert made == [] and isinstance(model, LM)
    assert {p.device.type for p in model.parameters()} == {"meta"}
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)


def test_fabric_kernels_refuse_meta():
    """B1-B4 take CUDA or CPU tensors only."""
    m = torch.empty((4, 8), dtype=torch.int32, device="meta")
    calls = [lambda: ops.fabric_queue_scan(m, m, m[:, 0]),
             lambda: ops.fabric_queue_update(m, m, m, *([m[0]] * 7)),
             lambda: ops.fabric_queue_multistep((m,), (), m[0], step_fn=None,
                                                chunk=1, max_steps=1,
                                                max_burst=1),
             lambda: ops.lif_step(m.float(), m.float())]
    for call in calls:
        with pytest.raises(ValueError, match="takes cuda or cpu"):
            call()
