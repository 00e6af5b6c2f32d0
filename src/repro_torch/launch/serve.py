"""Serving entry point: batched prefill + greedy decode loop.

The counterpart of the reference's ``launch/serve.py``: seed a model,
prefill a batch of ``SyntheticLM`` prompts, then step the decode caches
token by token with greedy sampling, and print the reference's summary
line.  It serves every causal architecture: the Mamba family
(falcon_mamba_7b), the dense family (granite_3_2b, qwen3_14b,
minitron_8b, granite_34b), the MoE family (mixtral_8x22b,
moonshot_v1_16b_a3b), the hybrid (jamba_v01_52b) and the vision decoder
(llama32_vision_11b, whose prompts carry ``SyntheticLM``'s stub image
embeddings; prefill fills the cross-attention caches once).  The
encoder hubert_xlarge is refused: it is scored (``LM.score``), as in
the reference, which has no decode path for it.  It runs on the CUDA
card unless ``--device cpu`` says otherwise; on the card each Mamba
block's prefill scan is one launch of the hand-written B7 kernel, and
attention, cross-attention, the FFN and the MoE run in PyTorch ops (the
reference has no TPU kernel for them either).  ``--layers`` cuts the
depth (the published widths kept) for a model that one card cannot
hold: mixtral-8x22b's 56 layers are about 564 GB of float32 weights,
two of them about 22 GB; one 8-layer period of jamba-v0.1-52b is about
53 GB of its ~206.  A model too large for one card is cut over a
``(data, model)`` mesh of ranks by ``shard_model`` and served through
``generate`` on every rank (the reference's serve has no mesh flag, and
neither has this one).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x22b \\
      --layers 2 --batch 2 --prompt-len 6144 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b \\
      --layers 8 --batch 2 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x22b \\
      --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs.base import get_config, get_smoke_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models.model import LM, build_model

__all__ = ["Generation", "pin_precision", "setup", "generate", "main"]


class Generation(NamedTuple):
    tokens: torch.Tensor      # (B, gen) int64, greedy
    logits: torch.Tensor      # (B, gen, V): the logits each token came from
    prefill_s: float          # prefill + first argmax, host clock
    decode_s: float           # the gen - 1 decode steps, host clock


def pin_precision() -> None:
    """Products as the reference computes them: bf16 products accumulate
    in float32 (XLA's rule; cuBLAS may otherwise reduce in bf16), and
    float32 products run in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.set_float32_matmul_precision("highest")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    return ap


def setup(argv=None):
    """Parse the flags, pin the product precision, seed the model and
    make the prompt batch: returns ``(args, cfg, model, batch)``,
    ``batch`` the ``SyntheticLM`` prompts on the model's device:
    ``{"tokens": (batch, prompt_len) int32}``, with ``"img_embed"``
    (batch, n_img_tokens, d_frontend) float32 for an ``"image+text"``
    model, as the reference's serve builds it."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    pin_precision()
    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    if not cfg.causal:
        raise ValueError(f"{args.arch} is encoder-only: nothing to decode")
    model = build_model(cfg, seed=args.seed, device=dev)
    data = SyntheticLM(cfg.vocab, args.prompt_len, args.batch,
                       seed=args.seed, modality=cfg.modality,
                       d_frontend=cfg.d_frontend,
                       n_img_tokens=cfg.n_img_tokens)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0).items()
             if k not in ("labels", "mask")}
    return args, cfg, model, batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def generate(model: LM, batch: dict, gen: int) -> Generation:
    """Prefill ``batch`` (``"tokens"`` (B, S) and, for an image model,
    ``"img_embed"``), then ``gen - 1`` greedy decode steps: ``gen`` new
    tokens, each the first argmax of its logits.  It runs under
    ``torch.inference_mode()``, so a model that was just trained (whose
    parameters need gradients) builds no autograd graph.  A model cut
    by ``parallel.tensor_parallel.shard_model`` is served the same way,
    every rank of its mesh calling this with the global batch: the
    logits come back whole on every rank, so every rank picks the same
    tokens."""
    bsz, s = batch["tokens"].shape
    dev = model.device
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_len=s + gen)
    tok = logits[:, -1].argmax(-1)[:, None]
    out_tokens, out_logits = [tok], [logits[:, -1]]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((bsz,), s + i, dtype=torch.int32, device=dev)  # torchlint: disable=TL002 (a fill, no copy)
        logits, cache = model.decode_step(cache, tok, pos)
        tok = logits[:, -1].argmax(-1)[:, None]
        out_tokens.append(tok)
        out_logits.append(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat(out_tokens, 1),
                      torch.stack(out_logits, 1), t_prefill, t_decode)


def main(argv=None) -> torch.Tensor:
    args, cfg, model, batch = setup(argv)
    res = generate(model, batch, args.gen)
    gen, t_prefill, t_decode = res.tokens, res.prefill_s, res.decode_s
    print(f"{cfg.name}: prefill({args.batch}x{args.prompt_len}) "
          f"{t_prefill*1e3:.1f} ms; decode {args.gen - 1} steps "
          f"{t_decode*1e3:.1f} ms "
          f"({(args.gen - 1) * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {list(map(int, gen[b][:12]))}")
    return gen


if __name__ == "__main__":
    main()
