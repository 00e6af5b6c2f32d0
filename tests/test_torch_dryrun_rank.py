"""The dry-run's trace of one rank's sharded program
(``launch.dryrun.trace_cell`` on a mesh of more than one device) held
on ``meta`` against its plain version, the tag-divided global trace
(``dryrun._trace_global``), and against hand counts of its collectives.

* Every smoke architecture, each kind (score for the encoder), on
  (2, 1), (1, 2) and (2, 2) meshes with FSDP, and the granite and
  falcon training cells with sequence parallelism: the rank's flops
  equal the global trace's per-device flops within 1e-6, plus the work
  a rank repeats that the tag division spreads over the model axis
  (``rank_excess``, a hand count); its argument bytes equal the spec
  count exactly.
* granite-3-2b and falcon-mamba-7b on (2, 2) with FSDP, train, prefill
  and decode: every collective the rank issues, by kind, axis and
  bytes, equal to a count from the layout (``dense_collectives``,
  ``mamba_collectives``).
"""

import collections

import pytest

from repro_torch.configs import base as B
from repro_torch.launch import cost, dryrun
from repro_torch.models.layers import padded_vocab
from repro_torch.models.transformer import _kinds
from repro_torch.parallel.compat import Mesh
from repro_torch.parallel.tensor_parallel import shard_model

SHAPES = {"train": B.ShapeConfig("train_s", 64, 8, "train"),
          "prefill": B.ShapeConfig("prefill_s", 128, 4, "prefill"),
          "decode": B.ShapeConfig("decode_s", 128, 8, "decode")}
MESHES = ((2, 1), (1, 2), (2, 2))


def _smoke(arch):
    s = B.get_smoke_config(arch)
    return {f: getattr(s, f) for f in s.__dataclass_fields__}


def rank_excess(cfg, kind: str, B_: int, S: int, dp: int, tp: int) -> float:
    """The flops a rank runs whole that the global trace divides over the
    model axis (its operands' tags carry it), by hand; each a product on
    the rank's ``B_ / dp`` rows that every rank of a model group repeats,
    so the excess is ``(1 - 1/tp)`` of it:

    * training, the frontend's weight gradient (audio frames or image
      tokens projected to d_model): the gradient reaching the projection
      is whole on every rank (*f* summed it), ``2·b·N·d_frontend·D``
      with N the frames (S) or the image tokens;
    * training, each MoE layer's router: the input gradient and the
      weight gradient of its ``D x E`` product, ``2 x 2·b·S·D·E``;
    * a decode step, each MoE layer's router forward, ``2·b·D·E`` (in
      the global decode its input carries the attention's model tag).
    """
    if tp == 1:
        return 0.0
    b = B_ // dp
    out = 0.0
    n_moe = sum(k.endswith("_moe") for k in _kinds(cfg))
    if kind == "train":
        if cfg.modality == "audio_frames":
            out += 2 * b * S * cfg.d_frontend * cfg.d_model
        elif cfg.modality == "image+text":
            out += 2 * b * cfg.n_img_tokens * cfg.d_frontend * cfg.d_model
        if n_moe:
            out += n_moe * 2 * (2 * b * S * cfg.d_model
                                * cfg.moe.num_experts)
    elif kind == "decode" and n_moe:
        out += n_moe * 2 * b * cfg.d_model * cfg.moe.num_experts
    return out * (1 - 1 / tp)


def _cells():
    out = []
    for arch in B.ARCH_IDS:
        kinds = ["train", "prefill"] + (["decode"] if
                                        B.get_smoke_config(arch).causal
                                        else [])
        out += [(arch, k, m, False) for k in kinds for m in MESHES]
    out += [(a, "train", (2, 2), True) for a in ("granite_3_2b",
                                                 "falcon_mamba_7b")]
    return out


@pytest.mark.parametrize("arch,kind,mesh,sp", _cells())
def test_rank_trace_against_global(arch, kind, mesh, sp):
    cfg = B.get_smoke_config(arch)
    run = B.RunConfig(seq_parallel=sp)
    m = Mesh({"data": mesh[0], "model": mesh[1]})
    shape = SHAPES[kind]
    res, _, mem = dryrun.trace_cell(arch, shape, m, run, _smoke(arch))
    want, _, want_mem = dryrun._trace_global(arch, shape, m, run,
                                             _smoke(arch))
    excess = rank_excess(cfg, kind, shape.global_batch, shape.seq_len,
                         *mesh)
    assert res["flops"] == pytest.approx(want["flops"] + excess, rel=1e-6)
    assert mem["argument_size_in_bytes"] == \
        want_mem["argument_size_in_bytes"]
    by_axis = res["collectives_by_axis"]
    assert ("model" in by_axis) == (mesh[1] > 1)
    # the global trace's step has no collective; the rank's all of them
    assert want["collectives"] == {} and by_axis
    assert "collectives_incomplete" not in res


# --- collectives by hand ------------------------------------------------

def _gathered(n: int, *shard) -> int:
    """Bytes of an all-gather's float32 result over ``n`` ranks."""
    return 4 * n * _numel(shard)


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def _fsdp(leaves: list, dp: int, kind: str) -> collections.Counter:
    """The FSDP collectives of ``leaves`` (each a shard's shape, f32):
    a gather over the data group each time a block runs (``n`` of
    them), and in training one reduce-scatter of each leaf's
    gradient."""
    out = collections.Counter()
    for shard, n in leaves:
        out["all-gather", "dp", _gathered(dp, *shard)] += n
        if kind == "train":
            out["reduce-scatter", "dp", 4 * _numel(shard)] += 1
    return out


def dense_collectives(cfg, kind: str, B_: int, S: int, dp: int,
                      tp: int) -> collections.Counter:
    """``(kind, axis, bytes)`` of every collective of a rank of an
    ``attn_ffn`` stack on a ``(dp, tp)`` mesh with FSDP, from the
    layout.  Each block's leaves are gathered whole over the data group
    when it runs: under ``remat`` training that is twice (the forward
    and the recompute), and a leaf's gradient is reduce-scattered once.
    The model axis: the vocab-parallel embedding's *g*, each attention's
    and FFN's closing *g* (the attention's also in the recompute; a
    non-reentrant checkpoint stops its recompute at the last tensor the
    backward saves, before the FFN's *g*), and in the backward the *f*
    at each attention's, FFN's and the head's input; the vocab-parallel
    cross-entropy's maximum and two sums; AdamW's norm over the groups
    of each split (data, and data + model), and the metrics' mean.  A
    prefill or decode step gathers its logits' vocabulary over the
    model group and its rows over the data group (bfloat16)."""
    D, H, K, dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff, padded_vocab(cfg.vocab),
                            cfg.n_layers)
    b, d = B_ // dp, D // dp
    runs = 2 if kind == "train" else 1
    layer = [((d,), runs), ((d,), runs),                       # ln1, ln2
             ((d, H * dh // tp), runs), ((d, K * dh // tp), runs),
             ((d, K * dh // tp), runs), ((H * dh // tp, d), runs),
             ((d, F // tp), runs), ((d, F // tp), runs),
             ((F // tp, d), runs)]
    top = [((V // tp, d), 1), ((d,), 1), ((d, V // tp), 1)]
    out = _fsdp(layer * L + top, dp, kind)
    rows = S if kind != "decode" else 1
    act = 4 * b * rows * D                      # f32 partial sums
    if kind == "train":
        out["all-reduce", "model", act] += 1 + 2 * L + L + (2 * L + 1)
        out["all-reduce", "model", 4 * b * S] += 3
        out["all-reduce", "dp", 4 * 5] += 1
        out["all-reduce", "dp", 4] += 2
        out["all-reduce", "model", 4] += 1
    else:
        out["all-reduce", "model", act] += 1 + 2 * L
        out["all-gather", "model", 2 * tp * b * V // tp] += 1
        out["all-gather", "dp", 2 * dp * b * V] += 1
    return out


def mamba_collectives(cfg, kind: str, B_: int, S: int, dp: int,
                      tp: int) -> collections.Counter:
    """As ``dense_collectives``, for a ``mamba`` stack: a layer gathers
    its norm, ``in_proj`` and ``out_proj`` over the data group (their
    other leaves have no ``embed`` dimension: split over the model axis
    only, and their gradients all-reduced over the data group under
    ``psum``); the model axis runs the embedding's *g*, the ``x_proj``
    partial sums' *g* (dt, B and C; also in the recompute), the layer's
    closing *g*, and in the backward the *f* at the layer's input and at
    its dt / B / C and at the head's input."""
    D, V, L = cfg.d_model, padded_vocab(cfg.vocab), cfg.n_layers
    m = cfg.mamba
    din, R, N, k = m.expand * D, cfg.dt_rank, m.d_state, m.d_conv
    b, d, c = B_ // dp, D // dp, din // tp
    runs = 2 if kind == "train" else 1
    layer = [((d,), runs), ((d, 2 * c), runs), ((c, d), runs)]
    top = [((V // tp, d), 1), ((d,), 1), ((d, V // tp), 1)]
    out = _fsdp(layer * L + top, dp, kind)
    rows = S if kind != "decode" else 1
    act = 4 * b * rows * D
    ssm = 4 * b * rows * (R + 2 * N)
    if kind == "train":
        out["all-reduce", "model", act] += 1 + L + (L + 1)
        out["all-reduce", "model", ssm] += 2 * L + L
        out["all-reduce", "model", 4 * b * S] += 3
        for shape in ((k, c), (c,), (c, R + 2 * N), (R, c), (c,), (c, N),
                      (c,)):        # conv_w, conv_b, x_proj, dt_proj,
            out["all-reduce", "dp", 4 * _numel(shape)] += L  # dt_bias,
        out["all-reduce", "dp", 4 * 5] += 1                 # A_log, D
        out["all-reduce", "dp", 4] += 2
        out["all-reduce", "model", 4] += 2
    else:
        out["all-reduce", "model", act] += 1 + L
        out["all-reduce", "model", ssm] += L
        out["all-gather", "model", 2 * tp * b * V // tp] += 1
        out["all-gather", "dp", 2 * dp * b * V] += 1
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,count", [
    ("granite_3_2b", dense_collectives),
    ("falcon_mamba_7b", mamba_collectives)])
def test_collectives_equal_hand_count(arch, count, kind, monkeypatch):
    cfg = B.get_smoke_config(arch)
    assert set(_kinds(cfg)) <= {"attn_ffn", "mamba"}
    seen = collections.Counter()
    record = cost.Counter.record_collective

    def spy(self, k, result, *, axis=None, ranks=None):
        seen[k, axis, result.numel() * result.element_size()] += 1
        return record(self, k, result, axis=axis, ranks=ranks)
    monkeypatch.setattr(cost.Counter, "record_collective", spy)
    shape = SHAPES[kind]
    res, _, _ = dryrun.trace_cell(arch, shape, Mesh({"data": 2,
                                                     "model": 2}),
                                  B.RunConfig(), _smoke(arch))
    want = count(cfg, kind, shape.global_batch, shape.seq_len, 2, 2)
    assert seen == want
    for k in cost.COLLECTIVES:
        assert res["collectives"].get(k, 0) == sum(
            n * nb for (kk, _, nb), n in want.items() if kk == k)
        assert res["collectives"].get(k + "_count", 0) == sum(
            n for (kk, _, _), n in want.items() if kk == k)
    assert {a: v["count"] for a, v in res["collectives_by_axis"].items()} \
        == {a: sum(n for (_, aa, _), n in want.items() if aa == a)
            for a in ("dp", "model")}
    if kind == "decode" and arch == "granite_3_2b":
        # the reference's decode all-reduce, 5,120 B a device
        assert res["collectives"]["all-reduce"] == 5120


def test_multipod_fsdp_over_data_alone():
    """On a ``(pod, data, model)`` mesh FSDP splits over ``"data"``
    alone: a rank gathers its leaves over its pod's data group, and a
    ``psum`` step completes an FSDP gradient's sum over the pod group;
    the flops and argument bytes still equal the global trace's."""
    mesh = Mesh({"pod": 2, "data": 2, "model": 2})
    arch = "granite_3_2b"
    res, _, mem = dryrun.trace_cell(arch, SHAPES["train"], mesh,
                                    B.RunConfig(), _smoke(arch))
    want, _, want_mem = dryrun._trace_global(arch, SHAPES["train"], mesh,
                                             B.RunConfig(), _smoke(arch))
    assert res["flops"] == pytest.approx(want["flops"], rel=1e-6)
    assert mem["argument_size_in_bytes"] == \
        want_mem["argument_size_in_bytes"]
    axes = res["collectives_by_axis"]
    assert set(axes) == {"dp", "data", "pod", "model"}
    assert (axes["data"]["ranks"], axes["pod"]["ranks"],
            axes["dp"]["ranks"], axes["model"]["ranks"]) == (
        [0, 2], [0, 4], [0, 2, 4, 6], [0, 1])
    # one all-reduce over the pod group per FSDP leaf (9 a layer, 3 more)
    assert axes["pod"]["count"] == 9 * 2 + 3


def test_trace_of_one_device_is_the_global_trace():
    """A 1 x 1 cell traces as it always did: the program, whole."""
    arch = "granite_3_2b"
    one = Mesh({"data": 1, "model": 1})
    res, _, mem = dryrun.trace_cell(arch, SHAPES["train"], one,
                                    B.RunConfig(), _smoke(arch))
    want, _, want_mem = dryrun._trace_global(arch, SHAPES["train"], one,
                                             B.RunConfig(), _smoke(arch))
    assert (res["flops"], res["bytes_accessed"], mem) == (
        want["flops"], want["bytes_accessed"], want_mem)
    assert res["collectives"] == {}


def _trace_as(arch, kind, mesh, run, over, coords):
    """``trace_cell``'s rank trace with the model's ``Parallel`` set by
    hand to the mesh coordinates ``coords`` (data, model): the shards
    keep rank 0's values, whose shapes every rank shares."""
    shape = SHAPES[kind]
    model, _, rules, shape, batch, _ = dryrun.build_cell(arch, shape, mesh,
                                                         run, over)
    par = shard_model(model, rules)
    par.dp_rank, par.tp_rank = coords
    state, cache = dryrun._setup(model, shape, run, rules)
    c = cost.Counter()
    dryrun.trace_step(model, kind, batch, run, counter=c, rules=rules,
                      seq_len=shape.seq_len, state=state, cache=cache)
    res = c.result()
    return res["flops"], res["bytes_accessed"], res["collectives"]


@pytest.mark.parametrize("arch,kind,sp", [
    ("granite_3_2b", "train", False), ("granite_3_2b", "prefill", False),
    ("granite_3_2b", "decode", False), ("granite_3_2b", "train", True),
    ("granite_3_2b", "prefill", True), ("falcon_mamba_7b", "decode", False)])
def test_every_rank_runs_rank_zeros_operators(arch, kind, sp):
    """The program of the last rank of a (2, 2) mesh counts what rank
    0's does, with a vocabulary whose padded ids lie in the last rank's
    block (500 of 512) and, under sequence parallelism, the last
    position on the last rank: what the dry-run's one trace stands for
    (the card's ranks are held to it in ``chip_smoke.py``)."""
    mesh = Mesh({"data": 2, "model": 2})
    over = dict(_smoke(arch), vocab=500)
    run = B.RunConfig(seq_parallel=sp)
    assert _trace_as(arch, kind, mesh, run, over, (1, 1)) == \
        _trace_as(arch, kind, mesh, run, over, (0, 0))
