"""Pod-scale dry-run: trace every (architecture x input shape x mesh)
cell on the ``meta`` device under the FLOP / byte counter and write the
roofline inputs a cell.  The counterpart of the reference's
``launch/dryrun.py``, which lowers and compiles each cell for 512 forced
host devices and reads XLA's analyses; here nothing is compiled and no
weight is allocated, so a full-width cell traces on a machine without a
GPU.

Per cell:
  train_*    -> ``LM.loss``, its backward and AdamW (the trainer's own
                step) under the cell's ``dp_reduce``;
  prefill_*  -> ``LM.prefill`` (last-token logits and the cache), or
                ``LM.score`` for an encoder;
  decode_*   -> one ``LM.decode_step`` against a ``seq_len``-deep cache.

Per-device numbers.  The dry-run does not execute the mesh (the
trainer, prefill, decode and scoring run a model axis and FSDP over
process groups of ranks, not over an abstract mesh): it traces the
global program, as the reference's SPMD program is global, and
accounts for the mesh as that program does.

  memory       ``argument_size_in_bytes`` sums each argument's bytes on
               one device (parameters, AdamW's moments, the AER
               residuals, the batch, the cache), every dim a spec shards
               ceil-divided by its mesh axes (the parameter specs of
               ``param_specs``, the batch's ``_batch_axis``, the
               reference's ``_cache_shardings``); ``temp_size_in_bytes``
               is the counter's peak of live bytes, divided the same way;
  flops, bytes each operator divided by the product of the mesh axes its
               result is tagged with (``launch.cost``): parameters carry
               their specs' axes, the batch its batch axes, activations
               the axes the model names through ``shard_activation``;
  collectives  only those the port's step issues: the data-parallel
               reduction of ``dp_reduce`` and the metrics' mean, recorded
               by the abstract mesh's ``RecordingGroup``.  The
               all-gathers, reduce-scatters and activation all-reduces
               that a model axis or FSDP runs in training, prefill,
               decode and scoring (and a sequence-split cache's softmax
               combine, and under ``--sp`` the residual stream's
               sequence gathers and reduce-scatters) are not traced
               (ROADMAP A.11e): such a cell's record says so in
               ``collectives_incomplete``.

Outputs, one a cell: ``experiments/dryrun_torch/<arch>--<shape>--<mesh>
[--tag].json`` with the reference's record keys (plus ``counter`` and
``torch``), and beside it ``.ops.json``, the operator tally, where the
reference writes its HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron_8b \\
      --shape train_4k --mesh pod           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from ..configs.base import (ALL_SHAPES, ARCH_IDS, RunConfig, ShapeConfig,
                            get_config, input_specs, shapes_for)
from ..models.model import build_model
from ..parallel.sharding import (PartitionSpec, make_rules, mesh_axes,
                                 use_rules)
from ..runtime import train_loop as tl
from . import cost
from .mesh import make_production_mesh

__all__ = ["OUT_DIR", "RECORD_KEYS", "MEMORY_KEYS", "INCOMPLETE",
           "build_cell", "trace_cell", "trace_step", "argument_specs",
           "device_bytes", "run_cell", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the reference's record keys (``dryrun.py:310-333``), then the port's
RECORD_KEYS = ("arch", "shape", "kind", "mesh", "cfg_overrides",
               "dp_reduce", "mesh_kind", "n_devices", "lower_s",
               "compile_s", "xla_flops_once", "xla_bytes_once", "flops",
               "bytes_accessed", "collectives", "collective_bytes_total",
               "unknown_trip_count_loops", "collectives_static_text",
               "memory", "counter", "torch")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes")
#: what a cell with a model axis past 1 or FSDP records of its
#: collectives
INCOMPLETE = ("the model axis's and FSDP's collectives are not traced "
              "(ROADMAP A.11e)")
COUNTER = "torch_dispatch_meta"


# --------------------------------------------------------------------------
# Specs: the reference's batch and cache shardings
# --------------------------------------------------------------------------

def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_axis(mesh, b: int, rules=None):
    """Mesh axis (or tuple of axes) of the batch dim, honouring an
    ``act:batch=none`` override; None when the batch does not divide
    over the data axes (the reference's rule)."""
    if rules is not None and "batch" in rules.act_map \
            and rules.act_map["batch"] is None:
        return None
    dp = _dp_axes(mesh)
    size = math.prod(mesh.shape[a] for a in dp)
    spec = dp if len(dp) > 1 else dp[0]
    return spec if b % size == 0 else None


def _cache_spec(name: str, t: torch.Tensor, mesh, rules) -> PartitionSpec:
    """The reference's ``_cache_shardings`` for one layer's leaf (the
    port's caches are per layer: the reference's periods axis, never
    sharded, is dropped)."""
    inner = rules.act_map.get("mamba_inner", "model")
    b = _batch_axis(mesh, t.shape[0], rules)
    if name in ("k", "v") and t.dim() == 4:
        return PartitionSpec(b, rules.act_map.get("kv_seq"),
                             rules.act_map.get("heads_kv"), None)
    if name == "slot_pos":
        return PartitionSpec(b, None)
    if name == "h" and t.dim() == 3:
        return PartitionSpec(b, inner, None)
    if name == "conv" and t.dim() == 3:
        return PartitionSpec(b, None, inner)
    return PartitionSpec()


def device_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of ``t`` on one device under ``spec``: each sharded dim
    ceil-divided by the product of its mesh axes."""
    n = 1
    for i, d in enumerate(t.shape):
        entry = spec[i] if i < len(spec) else None
        names = entry if isinstance(entry, tuple) else (entry,)
        n *= -(-d // math.prod(mesh.shape[a] for a in names
                               if a is not None))
    return n * t.element_size()


def argument_specs(model, rules, mesh, batch: dict, *, state=None,
                   cache=None) -> list:
    """``(tensor, spec)`` of every argument of the cell's program: the
    parameters (or the train state: parameters, both moments, the AER
    residuals and the two step counters), the batch, the cache."""
    axes = model.param_axes()
    out = []
    params = dict(model.named_parameters())
    for name, p in params.items():
        out.append((p, rules.param_spec(axes[name])))
    if state is not None:
        for tree in (state.opt.mu, state.opt.nu):
            out += [(t, rules.param_spec(axes[k])) for k, t in tree.items()]
        if state.aer is not None:
            out += [(s.residual, PartitionSpec()) for s in
                    state.aer.values()]
        out += [(state.opt.step, PartitionSpec()),
                (state.step, PartitionSpec())]
    for t in batch.values():
        b = _batch_axis(mesh, t.shape[0], rules)
        out.append((t, PartitionSpec(b)))
    for layer in cache or ():
        out += [(t, _cache_spec(k, t, mesh, rules)) for k, t in
                layer.items()]
    return out


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------

def build_cell(arch: str, shape_name, mesh, run_cfg: RunConfig,
               cfg_overrides: dict | None = None):
    """``(model, cfg, rules, shape, batch, meta)``: the model's
    parameters and the batch on ``meta``, the cell's rules.
    ``shape_name`` names one of ``ALL_SHAPES`` (which the arch must not
    skip), or is a ``ShapeConfig`` of its own (a cut-down cell)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    if isinstance(shape_name, ShapeConfig):
        shape, shape_name = shape_name, shape_name.name
    else:
        shape = ALL_SHAPES[shape_name]
        if shape not in shapes_for(cfg):
            raise ValueError(f"{arch} skips {shape_name}")
    model = build_model(cfg, device="meta")
    rules = make_rules(mesh, fsdp=run_cfg.fsdp,
                       seq_parallel=run_cfg.seq_parallel,
                       kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                       overrides=dict(run_cfg.rules_overrides)
                       if run_cfg.rules_overrides else None)
    batch = input_specs(cfg, shape)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "mesh": dict(mesh.shape), "cfg_overrides": cfg_overrides or {},
            "dp_reduce": run_cfg.dp_reduce}
    return model, cfg, rules, shape, batch, meta


def _prompt(batch: dict) -> dict:
    """What a prefill or a score reads of the batch (its labels and
    mask are not arguments of those programs)."""
    return {k: v for k, v in batch.items() if k not in ("labels", "mask")}


def trace_step(model, kind: str, batch: dict, run_cfg: RunConfig, *,
               counter, group=None, seq_len: int = 0, state=None,
               cache=None):
    """Run one step of ``kind`` as the cell runs it, under ``counter``
    (entered here); the same calls whatever the device, so a count on
    the card and a count on ``meta`` see the same operators.

    train:   the trainer's step over ``state`` (``init_state``; the
             data-parallel step recorded over ``group`` when it is a
             ``RecordingGroup``);
    prefill: ``prefill(max_len=seq_len)``, or ``score`` for an encoder;
    decode:  ``decode_step(cache, tokens, pos)``;
    both under ``no_grad`` (where inference mode would hand the counter
    composite operators whole).
    Returns what the step returned."""
    if kind == "train":
        step = tl.make_train_step(model, run_cfg) if group is None else \
            tl.make_recorded_step(model, run_cfg, group)
        with counter:
            return step(state, batch)
    with torch.no_grad(), counter:
        if kind == "prefill":
            if not model.cfg.causal:
                return model.score(batch)
            return model.prefill(_prompt(batch), max_len=seq_len)
        return model.decode_step(cache, batch["tokens"], batch["pos"])


@contextlib.contextmanager
def _grad_tags(model, counter, rules, axes):
    """Tag each gradient, once accumulated, with its parameter's mesh
    axes: the reduction's result on a device is the gradient's shard."""
    def hook(ax):
        def tag_grad(p):
            counter.tag(p.grad, ax)
        return tag_grad

    hooks = [p.register_post_accumulate_grad_hook(
        hook(mesh_axes(rules.param_spec(axes[n]))))
        for n, p in model.named_parameters()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def trace_cell(arch: str, shape_name: str, mesh, run_cfg: RunConfig,
               cfg_overrides: dict | None = None):
    """Trace one cell on ``meta``: ``(cost result, meta, memory)``, the
    numbers per device of ``mesh``."""
    model, cfg, rules, shape, batch, meta = build_cell(
        arch, shape_name, mesh, run_cfg, cfg_overrides)
    sharded = mesh.size > 1
    counter = cost.Counter(dict(mesh.shape) if sharded else None)
    axes = model.param_axes()
    state = cache = group = None
    read = batch
    if shape.kind == "train":
        state = tl.init_state(model, run_cfg)
        if mesh.dp_size > 1:
            group = mesh.dp_group
    elif shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        # only self-attention reads the position; the reference's jit
        # drops an argument nothing reads
        read = {k: batch[k] for k in ("tokens", "pos")
                if k == "tokens" or any(blk.kind.startswith("attn")
                                        for blk in model.stack.blocks)}
    else:
        read = _prompt(batch)
    args = argument_specs(model, rules, mesh, read, state=state,
                          cache=cache)
    for t, spec in args:
        counter.tag(t, mesh_axes(spec))
    tagging = _grad_tags(model, counter, rules, axes) \
        if shape.kind == "train" and sharded else contextlib.nullcontext()
    with use_rules(rules), tagging:
        out = trace_step(model, shape.kind, batch, run_cfg, group=group,
                         seq_len=shape.seq_len, counter=counter,
                         state=state, cache=cache)
    res = counter.result()
    outs = [t for t in torch.utils._pytree.tree_flatten(out)[0]
            if isinstance(t, torch.Tensor)]
    memory = {
        "argument_size_in_bytes": sum(device_bytes(t, s, mesh)
                                      for t, s in args),
        "output_size_in_bytes": int(sum(
            t.numel() * t.element_size() / counter.divisor(
                counter.axes_of([t])) for t in outs)),
        "temp_size_in_bytes": int(res["peak_live_bytes"]),
        "generated_code_size_in_bytes": None}
    return res, meta, memory


def _incomplete(mesh, run_cfg) -> bool:
    """A model axis past 1, or FSDP over a data axis past 1."""
    model_axes = any(n > 1 for a, n in mesh.shape.items()
                     if a not in ("pod", "data"))
    return model_axes or (run_cfg.fsdp and mesh.shape.get("data", 1) > 1)


def run_cell(arch, shape_name, mesh_kind, run_cfg, cfg_overrides=None,
             out_dir=OUT_DIR, tag="", mesh=None):
    """Trace one cell and write its record; returns the record."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=(mesh_kind == "multipod"))
    t0 = time.perf_counter()
    res, meta, memory = trace_cell(arch, shape_name, mesh, run_cfg,
                                   cfg_overrides)
    trace_s = time.perf_counter() - t0
    rec = dict(meta)
    rec.update({
        "mesh_kind": mesh_kind,
        "n_devices": mesh.size,
        "lower_s": round(trace_s, 2),
        "compile_s": 0.0,
        # eager tracing executes every loop body: "once" is the count
        "xla_flops_once": res["flops"],
        "xla_bytes_once": res["bytes_accessed"],
        "flops": res["flops"],
        "bytes_accessed": res["bytes_accessed"],
        "collectives": res["collectives"],
        "collective_bytes_total": res["collective_bytes_total"],
        "unknown_trip_count_loops": res["unknown_trip_count_loops"],
        "collectives_static_text": res["collectives"],
        "memory": memory,
        "counter": COUNTER,
        "torch": torch.__version__,
        "kernels": res["kernels"],
    })
    if _incomplete(mesh, run_cfg):
        rec["collectives_incomplete"] = INCOMPLETE
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}--{meta['shape']}--{mesh_kind}" \
        f"{('--' + tag) if tag else ''}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    with open(os.path.join(out_dir, name + ".ops.json"), "w") as f:
        json.dump(res["op_counts"], f, indent=1)
    print(f"[OK] {name}: trace={trace_s:.1f}s flops={rec['flops']:.3e} "
          f"bytes={rec['bytes_accessed']:.3e} "
          f"coll={rec['collective_bytes_total']:.3e}B "
          f"args={memory['argument_size_in_bytes']:.3e}B", flush=True)
    return rec


def _parse_rule(s: str):
    k, v = s.split("=", 1)
    if v == "none":
        return k, None
    return k, tuple(v.split("+")) if "+" in v else v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dp-reduce", default="psum")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--kv-chunk", type=int, default=0)
    ap.add_argument("--param-dtype", default=None, choices=["bf16", "f32"],
                    help="bf16 = inference-style weights (serve cells)")
    ap.add_argument("--rules-override", action="append", default=[],
                    help="logical rule override, e.g. "
                         "mamba_inner=data+model or act:batch=none")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    run_cfg = RunConfig(dp_reduce=args.dp_reduce, fsdp=not args.no_fsdp,
                        seq_parallel=args.sp,
                        rules_overrides=tuple(
                            _parse_rule(s) for s in args.rules_override))
    overrides = {}
    if args.remat:
        overrides["remat"] = args.remat
    if args.q_chunk:
        overrides["q_chunk"] = args.q_chunk
    if args.kv_chunk:
        overrides["kv_chunk"] = args.kv_chunk
    if args.param_dtype:
        overrides["param_dtype"] = (torch.bfloat16
                                    if args.param_dtype == "bf16"
                                    else torch.float32)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, s.name) for arch in ARCH_IDS
                 for s in shapes_for(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("name --arch and --shape, or pass --all")
        cells = [(args.arch, args.shape)]

    t0 = time.perf_counter()
    failures = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            try:
                run_cell(arch, shape, mesh_kind, run_cfg,
                         overrides or None, out_dir=args.out_dir,
                         tag=args.tag)
            except Exception as e:   # report every cell, then fail
                failures.append((arch, shape, mesh_kind, repr(e)))
                print(f"[FAIL] {arch}--{shape}--{mesh_kind}: {e}")
                traceback.print_exc()
    print(f"\n{len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
