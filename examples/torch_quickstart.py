"""Quickstart with the PyTorch port: build a model from the arch
registry, train it briefly on the synthetic stream, then serve a few
tokens from it.

    PYTHONPATH=src python examples/torch_quickstart.py [arch]          # card
    PYTHONPATH=src python examples/torch_quickstart.py [arch] --device cpu
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.base import RunConfig, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.model import build_model, param_count  # noqa: E402
from repro_torch.runtime.train_loop import (init_state,  # noqa: E402
                                            make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="granite_3_2b")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    run_cfg = RunConfig(learning_rate=3e-3, warmup_steps=5,
                        total_steps=args.steps)
    model = build_model(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab, seq_len=32, global_batch=8, seed=0,
                       modality=cfg.modality, d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)

    state = init_state(model, run_cfg)
    print(f"{cfg.name}: {param_count(model):,} params "
          f"(reduced config of the {args.arch} family)")
    step = make_train_step(model, run_cfg)

    losses = []
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if s % 10 == 0 or s == args.steps - 1:
            print(f"  step {s:3d}  loss={losses[-1]:.4f}  "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")

    tokens = None
    if cfg.causal:
        prompt = {k: v[:2, :16] for k, v in batch.items()
                  if k not in ("labels", "mask")}
        tokens = generate(model, prompt, 8).tokens
        print(f"  greedy continuation: {tokens[0].tolist()}")
    return losses, tokens


if __name__ == "__main__":
    main()
