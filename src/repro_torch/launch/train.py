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
116 GB of it, 16 layers about 36 GB.  ``--mesh-data > 1`` (manual data
parallelism over several cards) waits for ROADMAP A.11c.

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

from ..checkpoint import Checkpointer
from ..configs.base import RunConfig, get_config, get_smoke_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models.model import build_model, param_count
from ..runtime.fault import (FailureInjector, StragglerMonitor,
                             run_with_restarts)
from ..runtime.train_loop import init_state, make_train_step
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
                    help="manual DP over N devices (0 = single device; "
                         "more than 1 waits for ROADMAP A.11c)")
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


def setup(argv=None) -> Run:
    """Parse the flags, pin the product precision, seed the model on the
    device, and make the state, the step, the data and the checkpointer.
    Prints the run's line (parameters, the depth cut if any)."""
    args = parser().parse_args(argv)
    if args.mesh_data > 1:
        raise NotImplementedError(
            f"--mesh-data {args.mesh_data}: manual data parallelism over "
            f"several cards waits for ROADMAP A.11c")
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
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed,
                       modality=cfg.modality, d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    state = init_state(model, run_cfg)
    cut = (f" (depth cut from {full_layers} to {cfg.n_layers} layers)"
           if cfg.n_layers != full_layers else "")
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
               state=state, step_fn=make_train_step(model, run_cfg),
               data=DeviceData(), ckpt=Checkpointer(args.checkpoint_dir,
                                                    keep=3),
               injector=injector, monitor=StragglerMonitor())


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
    print(f"done in {dt:.1f}s — restarts={info['restarts']} "
          f"stragglers={len(info['straggler_events'])}")
    return state, dict(info, seconds=dt)


def main(argv=None, *, on_metrics=None):
    """``run(setup(argv))``: returns ``(state, info)``, ``info`` also
    holding the model (``"model"``) and its config (``"cfg"``)."""
    r = setup(argv)
    state, info = run(r, on_metrics=on_metrics)
    return state, dict(info, model=r.model, cfg=r.cfg)


if __name__ == "__main__":
    main()
