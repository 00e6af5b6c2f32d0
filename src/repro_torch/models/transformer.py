"""Layer stack of the LM: the block pattern and the stack's forward,
prefill and decode, for the ``"mamba"``, ``"attn_ffn"`` and
``"attn_moe"`` block kinds.

The counterpart of the reference's ``models/transformer.py``.  The
reference stacks each pattern position's parameters over periods and
runs one ``lax.scan``; the port keeps one module per layer in an
``nn.ModuleList`` and loops over it in Python (PyTorch runs eagerly;
layer ``l`` is the reference's period ``l // len(pattern)``, position
``l % len(pattern)``).  A block is ``x + mixer(ln1(x))`` then, for the
``_ffn`` / ``_moe`` kinds, ``x + ffn_or_moe(ln2(x))``.  Attention layers
keep a full K/V cache, or a window-deep ring cache when the sliding
window is shorter than the cache.  The hybrid kinds (``mamba_ffn``,
``mamba_moe``) and cross-attention (``xattn_ffn``) raise
``NotImplementedError`` until their slice (ROADMAP A.11).  The
reference's ``shard_activation`` annotations are dropped: the slice runs
on one card.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import mamba as M
from . import moe as MOE

__all__ = ["AUX_KEYS", "pattern_for", "n_periods", "Block", "Stack",
           "stack_init", "stack_apply", "init_cache", "stack_prefill",
           "_ring_positions", "stack_decode"]

#: the auxiliary sums a forward returns (the MoE blocks' losses)
AUX_KEYS = ("aux_loss", "z_loss", "drop_frac")
#: the block kinds the port runs
PORTED_KINDS = ("mamba", "attn_ffn", "attn_moe")


def pattern_for(cfg) -> tuple[str, ...]:
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.family == "mamba":
        return ("mamba",)
    if cfg.family == "vision":
        raise NotImplementedError(
            "family 'vision' is not ported yet (ROADMAP A.11: "
            "cross-attention and the image frontend come later)")
    if cfg.family == "moe":
        if cfg.moe_every <= 1:
            return ("attn_moe",)
        return ("attn_ffn",) * (cfg.moe_every - 1) + ("attn_moe",)
    return ("attn_ffn",)   # dense / encoder


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
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (ROADMAP A.11: "
                f"the hybrid and cross-attention blocks come later); the "
                f"port runs {PORTED_KINDS}")
    return [pat[i % len(pat)] for i in range(n_periods(cfg) * len(pat))]


class Block(nn.Module):
    """One block: ``ln1`` and its mixer (``mamba`` or ``attn``), then
    ``ln2`` and ``ffn`` or ``moe`` for the ``_ffn`` / ``_moe`` kinds."""

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.kind = kind
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        if kind == "mamba":
            self.mamba = M.Mamba(cfg, device=device)
        else:
            self.attn = L.Attention(cfg, device=device)
            self.ln2 = L.RMSNorm(cfg.d_model, device=device)
            if kind == "attn_ffn":
                self.ffn = L.FFN(cfg, device=device)
            else:
                self.moe = MOE.MoE(cfg, device=device)


class Stack(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, kind, device=device)
                                    for kind in _kinds(cfg))


def stack_init(stack: Stack, cfg, generator: torch.Generator) -> None:
    """Draw every block's random parameters in place, layer by layer."""
    for blk in stack.blocks:
        if blk.kind == "mamba":
            M.mamba_init(blk.mamba, cfg, generator)
            continue
        L.attn_init(blk.attn, cfg, generator)
        if blk.kind == "attn_ffn":
            L.ffn_init(blk.ffn, cfg, generator)
        else:
            MOE.moe_init(blk.moe, cfg, generator)


def _channel_mix(blk: Block, cfg, x: torch.Tensor):
    """``x + ffn_or_moe(ln2(x))`` and the MoE's aux dict (None for an
    FFN)."""
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    if blk.kind == "attn_ffn":
        return x + L.ffn_apply(blk.ffn, cfg, h), None
    y, aux = MOE.moe_apply(blk.moe, cfg, h)
    return x + y, aux


def _block_apply(blk: Block, cfg, x: torch.Tensor, positions):
    """One block's full-sequence forward: ``(x, aux or None)``."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    if blk.kind == "mamba":
        return x + M.mamba_apply(blk.mamba, cfg, h), None
    return _channel_mix(blk, cfg, x + L.attn_apply(blk.attn, cfg, h,
                                                   positions))


def stack_apply(stack: Stack, cfg, x: torch.Tensor, positions):
    """Full-sequence forward. x: (B, S, D); positions (B, S) -> (x, aux
    sums over layers, float32 scalars, summed in layer order)."""
    aux = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    for blk in stack.blocks:
        x, aux_b = _block_apply(blk, cfg, x, positions)
        if aux_b is not None:
            aux = {k: aux[k] + aux_b[k] for k in AUX_KEYS}
    return x, aux


def init_cache(cfg, batch: int, max_len: int, *, device=None) -> list:
    """One cache a layer: ``{"h", "conv"}`` (zeros) for a Mamba block, an
    attention cache (zeros; a ring's ``slot_pos`` −1) otherwise."""
    return [M.init_mamba_cache(cfg, batch, device=device) if kind == "mamba"
            else L.init_attn_cache(cfg, batch, max_len, device=device)
            for kind in _kinds(cfg)]


def _ring_positions(S: int, W: int, B: int, device=None) -> torch.Tensor:
    """Absolute positions of ring slots after prefilling S tokens: slot
    j holds position p with p % W == j and p in [S-W, S)."""
    base = torch.arange(W, device=device)
    start = S - W
    pos = start + (base - (start % W)) % W
    return pos.to(torch.int32).expand(B, W).contiguous()


def _attn_cache(k: torch.Tensor, v: torch.Tensor, max_len: int,
                W: int) -> dict:
    """The decode cache of one attention layer from its prefill k, v
    (B, S, K, dh): the last W positions rolled into ring order with
    their ``slot_pos`` when ``W``, else the whole prompt grown to
    ``max_len`` slots."""
    B, S = k.shape[:2]
    if not W:
        pad = (0, 0, 0, 0, 0, max_len - S)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}
    if S >= W:
        # ring invariant: slot j holds position p, p % W == j
        return {"k": torch.roll(k[:, -W:], S % W, 1),
                "v": torch.roll(v[:, -W:], S % W, 1),
                "slot_pos": _ring_positions(S, W, B, k.device)}
    pad = (0, 0, 0, 0, 0, W - S)
    sp = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
    sp[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
    return {"k": torch.nn.functional.pad(k, pad),
            "v": torch.nn.functional.pad(v, pad), "slot_pos": sp}


def stack_prefill(stack: Stack, cfg, x: torch.Tensor, positions,
                  max_len=None):
    """Forward that also returns the decode cache: ``(hidden, [cache of
    each layer])``.  Attention layers keep their K/V with room for
    ``max_len`` positions (a ring of the window when it is shorter);
    Mamba layers keep the final recurrent and conv state."""
    S = x.shape[1]
    max_len = max(max_len or 0, S)
    W = cfg.sliding_window if (cfg.sliding_window and
                               cfg.sliding_window < max_len) else 0
    caches = []
    for blk in stack.blocks:
        h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
        if blk.kind == "mamba":
            mix, st = M.mamba_prefill(blk.mamba, cfg, h)
            caches.append(st)
            x = x + mix
            continue
        mix, k, v = L._attn(blk.attn, cfg, h, positions)
        caches.append(_attn_cache(k, v, max_len, W))
        x, _ = _channel_mix(blk, cfg, x + mix)
    return x, caches


def stack_decode(stack: Stack, cfg, x: torch.Tensor, pos, cache: list):
    """One-token decode. x: (B, 1, D); ``pos`` (B,) the new token's
    absolute position (a Mamba block does not read it).  Returns ``(x,
    new cache)``; the input cache is left as it was."""
    new_cache = []
    for blk, c in zip(stack.blocks, cache, strict=True):
        h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
        if blk.kind == "mamba":
            mix, nc = M.mamba_decode(blk.mamba, cfg, h, c)
            new_cache.append(nc)
            x = x + mix
            continue
        mix, nc = L.attn_decode(blk.attn, cfg, h, c, pos)
        new_cache.append(nc)
        x, _ = _channel_mix(blk, cfg, x + mix)
    return x, new_cache
