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

Per-device numbers.  On a mesh of one device the dry-run traces the
program as it is.  On a mesh of more than one it traces what one rank
runs: the model built on ``meta`` and cut to rank 0's shards over the
abstract mesh (``tensor_parallel.shard_model``), then rank 0's train
step, prefill, score or decode step, exactly as a process of the mesh
runs it, with the mesh's ``RecordingGroup``s as its data-axis and
model-axis groups.  The counter counts that program as it stands, with
no division (every rank of the mesh runs the same operators on shards
of the same shapes):

  memory       ``argument_size_in_bytes`` sums the bytes of the rank's
               own arguments: its parameter shards, AdamW's moments of
               them, the AER residuals (whole leaves), the step
               counters, its rows of the batch and its block of the
               cache (``init_cache`` on the sharded model); this equals
               the reference's spec-based count (each dim a spec shards
               ceil-divided by its mesh axes: ``param_specs``,
               ``_batch_axis``, ``_cache_shardings``; ``argument_specs``
               and ``device_bytes`` here), which the tests hold it to;
               ``temp_size_in_bytes`` is the counter's peak of live
               bytes;
  flops, bytes every operator the rank dispatches, whole;
  collectives  every collective the rank issues, by kind and by the
               mesh axis its group spans (``collectives_by_axis``, with
               the group's global ranks, which the roofline prices by
               where they lie): the FSDP all-gathers and their backward
               reduce-scatters, Megatron's *f* and *g*, the
               vocab-parallel embedding and cross-entropy, the
               split-attention k/v gathers, both MoE layouts, the
               sharded AdamW norm, under ``--sp`` the residual stream's
               ``seq_enter`` and ``seq_exit``, a sequence-split decode
               cache's softmax combine, and the data-parallel reduction
               of every ``dp_reduce`` mode.

The reference's program is global and its numbers are XLA's per-device
analysis of it; the port's tests keep the global trace, every operator
divided by the product of the mesh axes its result is tagged with
(``_trace_global``), as the plain version the rank's trace is held
against: equal flops a device (but for work every rank of a model group
repeats, which the tag division spreads: counted by hand in the tests)
and equal argument bytes.

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
from ..parallel.tensor_parallel import shard_model
from ..runtime import train_loop as tl
from . import cost
from .mesh import make_production_mesh

__all__ = ["OUT_DIR", "RECORD_KEYS", "MEMORY_KEYS", "build_cell",
           "trace_cell", "trace_step", "rank_arguments", "argument_specs",
           "device_bytes", "run_cell", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the reference's record keys (``dryrun.py:310-333``), then the port's
RECORD_KEYS = ("arch", "shape", "kind", "mesh", "cfg_overrides",
               "dp_reduce", "mesh_kind", "n_devices", "lower_s",
               "compile_s", "xla_flops_once", "xla_bytes_once", "flops",
               "bytes_accessed", "collectives", "collective_bytes_total",
               "unknown_trip_count_loops", "collectives_static_text",
               "memory", "counter", "torch", "collectives_by_axis")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes")
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
               counter, rules=None, seq_len: int = 0, state=None,
               cache=None):
    """Run one step of ``kind`` as the cell runs it, under ``counter``
    (entered here); the same calls whatever the device, so a count on
    the card and a count on ``meta`` see the same operators.

    train:   the trainer's step over ``state`` (``init_state``), the
             sharded step under ``rules`` (the model already cut by
             them: ``make_train_step``);
    prefill: ``prefill(max_len=seq_len)``, or ``score`` for an encoder;
    decode:  ``decode_step(cache, tokens, pos)``;
    both under ``no_grad`` (where inference mode would hand the counter
    composite operators whole).
    Returns what the step returned."""
    if kind == "train":
        step = tl.make_train_step(model, run_cfg, rules)
        with counter:
            return step(state, batch)
    with torch.no_grad(), counter:
        if kind == "prefill":
            if not model.cfg.causal:
                return model.score(batch)
            return model.prefill(_prompt(batch), max_len=seq_len)
        return model.decode_step(cache, batch["tokens"], batch["pos"])


def _read(model, kind: str, batch: dict) -> dict:
    """The batch tensors the program of ``kind`` takes: all of a train
    batch; a prefill's or a score's prompt; a decode step's tokens, and
    their positions where a self-attention layer reads them (the
    reference's jit drops an argument nothing reads)."""
    if kind == "train":
        return batch
    if kind == "decode":
        return {k: batch[k] for k in ("tokens", "pos")
                if k == "tokens" or any(blk.kind.startswith("attn")
                                        for blk in model.stack.blocks)}
    return _prompt(batch)


def _setup(model, shape, run_cfg, rules=None) -> tuple:
    """``(state, cache)`` of a cell's program: the train state (the
    rank's, under ``rules``), or the decode cache (the rank's block on a
    sharded model)."""
    if shape.kind == "train":
        return tl.init_state(model, run_cfg, rules), None
    if shape.kind == "decode":
        return None, model.init_cache(shape.global_batch, shape.seq_len)
    return None, None


def rank_arguments(model, kind: str, read: dict, *, state=None,
                   cache=None) -> list:
    """The tensors that a rank of a sharded ``model``'s program of
    ``kind`` takes as arguments: its parameter shards (or its train
    state: the shards, both moments, the AER residuals and the two step
    counters), its rows of each ``read`` tensor (the train step's block
    of ``rows / dp``; ``Parallel.rows`` of a prefill, a score or a
    decode step), its cache."""
    par = model.parallel
    out = list(model.parameters())
    if state is not None:
        out += list(state.opt.mu.values()) + list(state.opt.nu.values())
        if state.aer is not None:
            out += [s.residual for s in state.aer.values()]
        out += [state.opt.step, state.step]
    for t in read.values():
        n = t.shape[0]
        m = n // par.dp
        out.append(t[par.rows(n) if kind != "train" else
                     slice(par.dp_rank * m, (par.dp_rank + 1) * m)])
    for layer in cache or ():
        out += list(layer.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _outputs(out) -> list:
    return [t for t in torch.utils._pytree.tree_flatten(out)[0]
            if isinstance(t, torch.Tensor)]


def trace_cell(arch: str, shape_name, mesh, run_cfg: RunConfig,
               cfg_overrides: dict | None = None):
    """Trace one cell on ``meta``: ``(cost result, meta, memory)``, the
    numbers of one device of ``mesh``: on a mesh of more than one
    device, rank 0's program (its shards, its rows, its collectives),
    counted whole; on one device, the program."""
    if mesh.size == 1:
        return _trace_global(arch, shape_name, mesh, run_cfg,
                             cfg_overrides)
    model, cfg, rules, shape, batch, meta = build_cell(
        arch, shape_name, mesh, run_cfg, cfg_overrides)
    shard_model(model, rules)         # rank 0's shards: no process groups
    state, cache = _setup(model, shape, run_cfg, rules)
    args = rank_arguments(model, shape.kind,
                          _read(model, shape.kind, batch), state=state,
                          cache=cache)
    counter = cost.Counter()
    out = trace_step(model, shape.kind, batch, run_cfg, counter=counter,
                     rules=rules, seq_len=shape.seq_len, state=state,
                     cache=cache)
    res = counter.result()
    memory = {
        "argument_size_in_bytes": sum(map(_nbytes, args)),
        "output_size_in_bytes": sum(map(_nbytes, _outputs(out))),
        "temp_size_in_bytes": int(res["peak_live_bytes"]),
        "generated_code_size_in_bytes": None}
    return res, meta, memory


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


def _trace_global(arch: str, shape_name, mesh, run_cfg: RunConfig,
                  cfg_overrides: dict | None = None):
    """The plain version of ``trace_cell``: the global program (the
    whole model, the global batch, the one-device train step, so no
    collective) traced on ``meta``, each operator divided by the product
    of the mesh axes its result is tagged with, the arguments counted
    from their specs (``argument_specs``, ``device_bytes``).  ``(cost
    result, meta, memory)``, per device of ``mesh``.  On one device it
    is the dry-run's trace."""
    model, cfg, rules, shape, batch, meta = build_cell(
        arch, shape_name, mesh, run_cfg, cfg_overrides)
    sharded = mesh.size > 1
    counter = cost.Counter(dict(mesh.shape) if sharded else None)
    state, cache = _setup(model, shape, run_cfg)
    args = argument_specs(model, rules, mesh,
                          _read(model, shape.kind, batch), state=state,
                          cache=cache)
    for t, spec in args:
        counter.tag(t, mesh_axes(spec))
    tagging = _grad_tags(model, counter, rules, model.param_axes()) \
        if shape.kind == "train" and sharded else contextlib.nullcontext()
    with use_rules(rules), tagging:
        out = trace_step(model, shape.kind, batch, run_cfg,
                         seq_len=shape.seq_len, counter=counter,
                         state=state, cache=cache)
    res = counter.result()
    memory = {
        "argument_size_in_bytes": sum(device_bytes(t, s, mesh)
                                      for t, s in args),
        "output_size_in_bytes": int(sum(
            _nbytes(t) / counter.divisor(counter.axes_of([t]))
            for t in _outputs(out))),
        "temp_size_in_bytes": int(res["peak_live_bytes"]),
        "generated_code_size_in_bytes": None}
    return res, meta, memory


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
        "collectives_by_axis": res["collectives_by_axis"],
        "unknown_trip_count_loops": res["unknown_trip_count_loops"],
        "collectives_static_text": res["collectives"],
        "memory": memory,
        "counter": COUNTER,
        "torch": torch.__version__,
        "kernels": res["kernels"],
    })
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
