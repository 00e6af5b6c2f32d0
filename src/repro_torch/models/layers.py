"""Model substrate of the LM stack: parameter helpers, linear products,
RMSNorm, the token embedding and the output head.

The counterpart of the reference's ``models/layers.py``, cut to what the
Mamba serving path needs (attention, RoPE and the FFN come with their
slice, ROADMAP A.11).  Parameters are stored in ``cfg.param_dtype``
(float32 master copies) and cast to ``cfg.compute_dtype`` (bfloat16) per
product; normalisation statistics are float32.  Parameters are
``nn.Parameter``s that need no gradient: the port serves, and training
comes later.  The reference's ``shard_activation`` annotations are
dropped: the slice runs on one card.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["_normal", "param", "linear", "RMSNorm", "rmsnorm",
           "padded_vocab", "Embed", "embed_init", "embed", "Head",
           "head_init", "mask_padded_vocab", "cross_entropy"]


def _normal(generator: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale²) drawn in float32 on the generator's device, then cast
    to ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def param(shape, dtype: torch.dtype, device, fill=None) -> nn.Parameter:
    """An uninitialised (or ``fill``-ed) parameter that needs no
    gradient."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def linear(w: torch.Tensor, x: torch.Tensor,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both cast to ``compute_dtype`` per call, as the
    reference's ``x.astype(cd) @ w.astype(cd)``.  XLA accumulates a bf16
    product in float32; cuBLAS does too once
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is off, which the serve entry point sets."""
    return x.to(compute_dtype) @ w.to(compute_dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = param((d,), torch.float32, device, fill=1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in float32, output in ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale.float()).to(x.dtype)


def padded_vocab(vocab: int, mult: int = 128) -> int:
    """Megatron-style vocab padding; padded ids are masked to -1e9 in the
    head and never appear in labels."""
    return -(-vocab // mult) * mult


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.table = param((padded_vocab(vocab), d), dtype, device)


def embed_init(p: Embed, generator: torch.Generator) -> None:
    p.table.copy_(_normal(generator, p.table.shape, 0.02, p.table.dtype))


def embed(p: Embed, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the values of the reference's cast-then-gather,
    # without a compute-dtype copy of the whole table each call
    return p.table[tokens.long()].to(compute_dtype)


class Head(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.w = param((cfg.d_model, padded_vocab(cfg.vocab)),
                       cfg.param_dtype, device)


def head_init(p: Head, cfg, generator: torch.Generator) -> None:
    p.w.copy_(_normal(generator, p.w.shape, cfg.d_model ** -0.5,
                      p.w.dtype))


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    v_pad = logits.shape[-1]
    if v_pad == vocab:
        return logits
    live = torch.arange(v_pad, device=logits.device) < vocab
    return logits + torch.where(live, 0.0, -1e9).to(logits.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean token NLL in float32. logits: (B, S, V); labels: (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
