"""Top-level LM: embedding + block stack + final norm + head, and the
serving entry points.

The counterpart of the reference's ``models/model.py`` for token LMs
whose blocks the port runs (the Mamba family, so far).  ``LM`` is an
``nn.Module`` holding the parameters, named as the reference's tree
(``embed.table``, ``stack.blocks.<l>.{ln1,mamba}``, ``ln_f.scale``,
``head.w``); ``build_model`` draws them from a seeded
``torch.Generator`` on the model's device.  The methods mirror the
reference's pure functions:

  forward(batch)                 -> (logits, aux)     full-sequence
  score(batch)                   -> logits
  init_cache(batch, max_len)     -> cache (one {"h", "conv"} a layer)
  prefill(batch, max_len=None)   -> (last-position logits, cache)
  decode_step(cache, tokens, pos) -> (logits, cache)

``batch`` is ``{"tokens": (B, S) int}``.  The loss, chunked
cross-entropy, tied embeddings and the audio/vision frontends come
later (ROADMAP A.11).  The reference's ``shard_activation`` annotations
are dropped: the slice runs on one card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from . import transformer as T

__all__ = ["LM", "build_model", "param_count"]

_AUX_KEYS = ("aux_loss", "z_loss", "drop_frac")


class LM(nn.Module):
    """The parameters, uninitialised until ``init`` (or a load)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.modality != "text" or cfg.tie_embeddings:
            raise NotImplementedError(
                "frontends and tied embeddings are not ported yet "
                "(ROADMAP A.11)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L.Embed(cfg.vocab, cfg.d_model, cfg.param_dtype,
                             device=dev)
        self.stack = T.Stack(cfg, device=dev)
        self.ln_f = L.RMSNorm(cfg.d_model, device=dev)
        self.head = L.Head(cfg, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init(self, generator: torch.Generator) -> "LM":
        """Draw every random parameter in place from ``generator`` (on
        the model's device): the embedding, each layer, the head."""
        L.embed_init(self.embed, generator)
        T.stack_init(self.stack, self.cfg, generator)
        L.head_init(self.head, self.cfg, generator)
        return self

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rmsnorm(self.ln_f, h, cfg.norm_eps)
        logits = L.linear(self.head.w, h, cfg.compute_dtype)
        return L.mask_padded_vocab(logits, cfg.vocab)

    def forward(self, batch: dict):
        cfg = self.cfg
        h = L.embed(self.embed, batch["tokens"], cfg.compute_dtype)
        h = T.stack_apply(self.stack, cfg, h)
        aux = {k: torch.zeros((), device=h.device) for k in _AUX_KEYS}
        return self._head(h), aux

    def score(self, batch: dict) -> torch.Tensor:
        """Full-sequence logits (no cache)."""
        return self.forward(batch)[0]

    def init_cache(self, batch_size: int, max_len: int) -> list:
        return T.init_cache(self.cfg, batch_size, max_len,
                            device=self.device)

    def prefill(self, batch: dict, max_len=None):
        """Returns (logits for the last position (B, 1, V), decode
        cache)."""
        cfg = self.cfg
        h = L.embed(self.embed, batch["tokens"], cfg.compute_dtype)
        h, cache = T.stack_prefill(self.stack, cfg, h, max_len=max_len)
        return self._head(h[:, -1:]), cache

    def decode_step(self, cache: list, tokens: torch.Tensor, pos):
        """tokens: (B, 1) int; pos: (B,) absolute positions."""
        cfg = self.cfg
        h = L.embed(self.embed, tokens, cfg.compute_dtype)
        h, cache = T.stack_decode(self.stack, cfg, h, pos, cache)
        return self._head(h), cache


def build_model(cfg, *, seed: int = 0, device=None) -> LM:
    """An ``LM`` on ``device`` (``None``: the CUDA card) with parameters
    drawn from ``torch.Generator(device).manual_seed(seed)``; one seed
    gives one model per device type (CPU and CUDA generators differ)."""
    dev = resolve_device(device)
    return LM(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
