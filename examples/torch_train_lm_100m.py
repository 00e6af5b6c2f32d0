"""End-to-end driver with the PyTorch port: train a ~100M-parameter
granite-family LM for a few hundred steps on the synthetic pipeline,
with checkpointing, a mid-run injected failure + restart, and straggler
monitoring — the full production loop at laptop scale.

It asserts what the loop promises: one restart for the one injected
failure, the run ending at its last step, the last checkpoint at the
last multiple of the checkpoint interval, and finite losses.  ``main``
returns ``(state, info)``, ``info`` with the restarts, the straggler
events, the checkpoint steps kept and the last step's loss.

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

    losses = {}
    every = max(steps // 6, 1)
    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d, keep=2)
        injector = FailureInjector(frozenset({steps // 2}))  # mid-run crash
        monitor = StragglerMonitor()
        state, info = run_with_restarts(
            n_steps=steps, state=state, train_step=step_fn,
            data=DeviceData(), ckpt=ckpt, checkpoint_every=every,
            injector=injector, monitor=monitor,
            log_every=max(steps // 12, 1),
            on_metrics=lambda s, m: losses.update({s: m["loss"]}))
        info["checkpoints"] = ckpt.all_steps()
        print(f"finished at step {steps}: restarts={info['restarts']} "
              f"(injected 1), stragglers flagged="
              f"{len(info['straggler_events'])}")
    info["last_loss"] = float(losses[steps])
    assert info["restarts"] == 1, info["restarts"]
    assert int(state.step) == steps, int(state.step)
    assert info["checkpoints"][-1] == steps // every * every, \
        info["checkpoints"]
    assert sorted(losses) == list(range(1, steps + 1))
    assert all(torch.isfinite(v).all() for v in losses.values())
    return state, info


if __name__ == "__main__":
    main()
