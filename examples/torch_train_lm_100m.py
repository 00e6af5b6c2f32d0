"""End-to-end driver with the PyTorch port: train a ~100M-parameter
granite-family LM for a few hundred steps on the synthetic pipeline,
with checkpointing, a mid-run injected failure + restart, and straggler
monitoring — the full production loop at laptop scale.

    PYTHONPATH=src python examples/torch_train_lm_100m.py          # card
    PYTHONPATH=src python examples/torch_train_lm_100m.py --tiny --device cpu
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.base import ModelConfig, RunConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import build_model, param_count  # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,  # noqa: E402
                                       StragglerMonitor, run_with_restarts)
from repro_torch.runtime.train_loop import (init_state,  # noqa: E402
                                            make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="2M-param config for quick verification")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.tiny:
        cfg = ModelConfig(name="lm-tiny", n_layers=4, d_model=128,
                          n_heads=4, n_kv_heads=2, d_ff=512, vocab=2048)
        steps, batch, seq = args.steps or 120, 8, 64
    else:
        # ~100M params: 12L x d768 (GQA 12/4) + 32k vocab
        cfg = ModelConfig(name="lm-100m", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=4, d_ff=3072, vocab=32768)
        steps, batch, seq = args.steps or 300, 16, 256

    run_cfg = RunConfig(learning_rate=3e-3, warmup_steps=steps // 10,
                        total_steps=steps, grad_clip=1.0)
    model = build_model(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=1)

    state = init_state(model, run_cfg)
    print(f"{cfg.name}: {param_count(model):,} params — "
          f"{steps} steps x {batch}x{seq} tokens")
    step_fn = make_train_step(model, run_cfg)

    class DeviceData:
        def batch(self, s):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in data.batch(s).items()}

    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d, keep=2)
        injector = FailureInjector(frozenset({steps // 2}))  # mid-run crash
        monitor = StragglerMonitor()
        state, info = run_with_restarts(
            n_steps=steps, state=state, train_step=step_fn,
            data=DeviceData(), ckpt=ckpt,
            checkpoint_every=max(steps // 6, 1), injector=injector,
            monitor=monitor, log_every=max(steps // 12, 1))
        print(f"finished at step {steps}: restarts={info['restarts']} "
              f"(injected 1), stragglers flagged="
              f"{len(info['straggler_events'])}")
    return state, info


if __name__ == "__main__":
    main()
