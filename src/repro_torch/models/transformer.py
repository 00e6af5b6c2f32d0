"""Layer stack of the LM: the block pattern and the stack's forward,
prefill and decode, for the ``"mamba"`` block kind.

The counterpart of the reference's ``models/transformer.py``.  The
reference stacks each pattern position's parameters over periods and
runs one ``lax.scan``; the port keeps one module per layer in an
``nn.ModuleList`` and loops over it in Python (PyTorch runs eagerly;
layer ``l`` is the reference's period ``l // len(pattern)``, position
``l % len(pattern)``).  A block is ``x + mamba(rmsnorm(x))``.  The
other block kinds (attention, FFN, MoE, cross-attention) raise
``NotImplementedError`` until their slice (ROADMAP A.11).  The
reference's ``shard_activation`` annotations are dropped: the slice runs
on one card.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import mamba as M

__all__ = ["pattern_for", "n_periods", "Block", "Stack", "stack_init",
           "stack_apply", "init_cache", "stack_prefill", "stack_decode"]


def pattern_for(cfg) -> tuple[str, ...]:
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.family == "mamba":
        return ("mamba",)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP A.11: "
        f"attention, FFN and MoE blocks come later)")


def n_periods(cfg) -> int:
    pat = pattern_for(cfg)
    if cfg.n_layers % len(pat):
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"pattern {pat}")
    return cfg.n_layers // len(pat)


def _kinds(cfg) -> list[str]:
    """The block kind of every layer, refusing kinds not ported."""
    pat = pattern_for(cfg)
    for kind in pat:
        if kind != "mamba":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (ROADMAP A.11); "
                f"the port runs 'mamba' blocks")
    return [pat[i % len(pat)] for i in range(n_periods(cfg) * len(pat))]


class Block(nn.Module):
    """One ``"mamba"`` block: ``ln1`` and the mixer."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        self.mamba = M.Mamba(cfg, device=device)


class Stack(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in _kinds(cfg))


def stack_init(stack: Stack, cfg, generator: torch.Generator) -> None:
    """Draw every block's random parameters in place, layer by layer."""
    for blk in stack.blocks:
        M.mamba_init(blk.mamba, cfg, generator)


def stack_apply(stack: Stack, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: (B, S, D) -> (B, S, D)."""
    for blk in stack.blocks:
        x = x + M.mamba_apply(blk.mamba, cfg,
                              L.rmsnorm(blk.ln1, x, cfg.norm_eps))
    return x


def init_cache(cfg, batch: int, max_len: int, *, device=None) -> list:
    """One ``{"h", "conv"}`` cache a layer (zeros); ``max_len`` is the
    reference's argument, which a Mamba cache does not need."""
    return [M.init_mamba_cache(cfg, batch, device=device)
            for _ in _kinds(cfg)]


def stack_prefill(stack: Stack, cfg, x: torch.Tensor, max_len=None):
    """Forward that also returns the decode cache: ``(hidden, [cache of
    each layer])``."""
    caches = []
    for blk in stack.blocks:
        mix, st = M.mamba_prefill(blk.mamba, cfg,
                                  L.rmsnorm(blk.ln1, x, cfg.norm_eps))
        caches.append(st)
        x = x + mix
    return x, caches


def stack_decode(stack: Stack, cfg, x: torch.Tensor, pos, cache: list):
    """One-token decode. x: (B, 1, D); ``pos`` (B,) is the reference's
    argument, which a Mamba block does not read.  Returns ``(x, new
    cache)``."""
    new_cache = []
    for blk, c in zip(stack.blocks, cache, strict=True):
        mix, nc = M.mamba_decode(blk.mamba, cfg,
                                 L.rmsnorm(blk.ln1, x, cfg.norm_eps), c)
        new_cache.append(nc)
        x = x + mix
    return x, new_cache
