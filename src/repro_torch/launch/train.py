"""Training entry point, the port's counterpart of the reference's
``launch/train.py``.

It wires together the model (seeded on the device), ``SyntheticLM`` data
(numpy, a pure function of ``--seed`` and the step), AdamW, checkpoints
with restarts, failure-injection drills and straggler monitoring, and
trains on the CUDA card unless ``--device cpu`` says otherwise.  Each
Mamba block's scan is the hand-written B7 kernel forward and its
backward kernel; the rest is PyTorch ops and autograd.  ``--layers``
cuts the depth (the published widths kept) for a model whose training
state (float32 parameters, gradients and two moments, 16 bytes a
parameter) one card cannot hold: falcon-mamba-7b's 64 layers are about
116 GB of it, 16 layers about 36 GB.

``--mesh-data N`` (N > 1) trains data-parallel over N processes, one a
rank, as ``torchrun`` starts them: it reads ``RANK``, ``WORLD_SIZE``
(which must be N) and ``LOCAL_RANK``, joins the process group (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``; ``MASTER_ADDR`` and
``MASTER_PORT`` from ``torchrun``), builds ``make_host_mesh(data=N)``
and ``make_rules(fsdp=False)``, hands every rank rank 0's parameters,
and reduces the gradients with ``--dp-reduce``.  ``--batch`` is the
global batch; each rank trains on its ``batch / N`` rows.  Only rank 0
prints.

On the card the step runs under PyTorch's deterministic algorithms (so
a restarted run ends bit-identical to an uninterrupted one), which need
``CUBLAS_WORKSPACE_CONFIG`` before the process's first matrix product:
``runtime.train_loop`` sets ``:4096:8`` when the variable is unset, as
this module imports it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch falcon_mamba_7b --layers 16 --batch 4 --seq 2048 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --device cpu --steps 30 --fail-at 11,23 \\
      --checkpoint-every 10                     # restart drill
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs.base import RunConfig, get_config, get_smoke_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models.model import build_model, param_count
from ..parallel.sharding import make_rules
from ..runtime.fault import (FailureInjector, StragglerMonitor,
                             run_with_restarts)
from ..runtime.train_loop import init_state, make_train_step
from .mesh import make_host_mesh
from .serve import pin_precision

__all__ = ["parser", "Run", "setup", "run", "main"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dp-reduce", default="psum",
                    choices=["psum", "ring", "bidir_ring", "aer_topk"])
    ap.add_argument("--aer-frac", type=float, default=0.05)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data parallelism over N ranks started by "
                         "torchrun (0 or 1 = one device)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps for injected failures")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    return ap


class Run(NamedTuple):
    """A training run set up and not yet started."""
    args: argparse.Namespace
    cfg: object
    run_cfg: RunConfig
    model: torch.nn.Module
    state: object             # the TrainState at step 0
    step_fn: object           # make_train_step(model, run_cfg)
    data: object              # .batch(step) -> tensors on the device
    ckpt: Checkpointer
    injector: FailureInjector | None
    monitor: StragglerMonitor
    rules: object             # the mesh's sharding rules (None: one device)
    owns_group: bool          # setup joined the process group


def _join_group(n: int, device):
    """Join ``torchrun``'s process group of ``n`` ranks (unless this
    process already belongs to one); returns ``(device, joined)``."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if n != world:
        raise ValueError(f"--mesh-data {n} needs {n} processes (torchrun "
                         f"--nproc-per-node {n}); WORLD_SIZE is {world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]), world_size=n)
    return dev, True


def setup(argv=None) -> Run:
    """Parse the flags, pin the product precision, seed the model on the
    device, and make the state, the step, the data and the checkpointer.
    Prints the run's line (parameters, the depth cut if any)."""
    args = parser().parse_args(argv)
    owns = False
    if args.mesh_data > 1:
        dev, owns = _join_group(args.mesh_data, args.device)
    else:
        dev = resolve_device(args.device)
    pin_precision()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    full_layers = cfg.n_layers
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    run_cfg = RunConfig(dp_reduce=args.dp_reduce, learning_rate=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps, aer_frac=args.aer_frac,
                        checkpoint_every=args.checkpoint_every, fsdp=False)
    model = build_model(cfg, seed=args.seed, device=dev)
    rules = group = None
    lead = True
    if args.mesh_data > 1:
        mesh = make_host_mesh(data=args.mesh_data, model=1)
        rules = make_rules(mesh, fsdp=False, kv_heads=cfg.n_kv_heads,
                           d_head=cfg.d_head)
        group = mesh.dp_group
        lead = dist.get_rank() == 0
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p, 0, group=group)
        if lead:
            print(f"mesh: {dict(mesh.shape)} dp_reduce={args.dp_reduce} "
                  f"backend={dist.get_backend(group)}")
    if not lead:
        args.log_every = 0
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed,
                       modality=cfg.modality, d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    state = init_state(model, run_cfg)
    cut = (f" (depth cut from {full_layers} to {cfg.n_layers} layers)"
           if cfg.n_layers != full_layers else "")
    if lead:
        print(f"{cfg.name}: {param_count(model):,} params{cut}, "
              f"{args.steps} steps, reduce={args.dp_reduce}, device={dev}")

    class DeviceData:
        def batch(self, s):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in data.batch(s).items()}

    injector = FailureInjector(frozenset(
        int(s) for s in args.fail_at.split(",") if s)) if args.fail_at \
        else None
    return Run(args=args, cfg=cfg, run_cfg=run_cfg, model=model,
               state=state, step_fn=make_train_step(model, run_cfg, rules),
               data=DeviceData(), ckpt=Checkpointer(args.checkpoint_dir,
                                                    keep=3, group=group),
               injector=injector, monitor=StragglerMonitor(), rules=rules,
               owns_group=owns)


def run(r: Run, *, on_metrics=None):
    """Train a set-up run to ``--steps`` through ``run_with_restarts``;
    returns ``(state, info)`` (restarts, straggler events, and the loop's
    ``"seconds"``).  ``on_metrics(step, metrics)`` is called after each
    step."""
    t0 = time.time()
    state, info = run_with_restarts(
        n_steps=r.args.steps, state=r.state, train_step=r.step_fn,
        data=r.data, ckpt=r.ckpt, checkpoint_every=r.args.checkpoint_every,
        injector=r.injector, monitor=r.monitor, log_every=r.args.log_every,
        on_metrics=on_metrics)
    dt = time.time() - t0
    if r.rules is None or dist.get_rank() == 0:
        print(f"done in {dt:.1f}s — restarts={info['restarts']} "
              f"stragglers={len(info['straggler_events'])}")
    return state, dict(info, seconds=dt)


def main(argv=None, *, on_metrics=None):
    """``run(setup(argv))``: returns ``(state, info)``, ``info`` also
    holding the model (``"model"``) and its config (``"cfg"``)."""
    r = setup(argv)
    try:
        state, info = run(r, on_metrics=on_metrics)
    finally:
        if r.owns_group:
            dist.destroy_process_group()
    return state, dict(info, model=r.model, cfg=r.cfg)


if __name__ == "__main__":
    main()
