"""Layer stack of the LM: the block pattern and the stack's forward,
prefill and decode, for every block kind of the reference:
``attn_ffn``, ``attn_moe``, ``xattn_ffn``, ``mamba``, ``mamba_ffn`` and
``mamba_moe``.

The counterpart of the reference's ``models/transformer.py``.  The
reference stacks each pattern position's parameters over periods and
runs one ``lax.scan``; the port keeps one module per layer in an
``nn.ModuleList`` and loops over it in Python (PyTorch runs eagerly;
layer ``l`` is the reference's period ``l // len(pattern)``, position
``l % len(pattern)``).  A block is ``x + mixer(ln1(x))`` then, for the
``_ffn`` / ``_moe`` kinds, ``x + ffn_or_moe(ln2(x))``; the mixer is
self-attention (``attn_*``), a Mamba layer (``mamba*``) or gated
cross-attention over the image tokens (``xattn_*``: its output times
``tanh(xgate)``, the gate a float32 scalar initialised to 0 as in the
reference, so a fresh model's image changes nothing).  Attention layers
keep a full K/V cache, or a window-deep ring cache when the sliding
window is shorter than the cache; cross-attention layers keep the image
tokens' K/V, filled once by prefill (or ``precompute_cross_cache``) and
never written by decode.  The reference's ``shard_activation``
annotations are kept at its places, one a pattern period (no-ops unless
sharding rules are installed).  Under autograd
``stack_apply`` follows ``cfg.remat`` as the reference's layer scan
does, one pattern period (the reference's scan body) at a time:
``"full"`` recomputes a period's activations in backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the
matrix products' outputs and recomputes the rest (a selective
checkpoint whose policy saves ``aten.mm`` and ``aten.bmm``), ``"none"``
keeps everything; the values are the same under each.

A sharded model's training forward (``stack_apply(..., par=)``, the
model's ``parallel.tensor_parallel.Parallel``) passes ``par`` to every
block: each block reads its weights from ``par.view(block)``, which
gathers its FSDP leaves over the data group inside the checkpointed
function (the recompute gathers them again, so no gathered weight
outlives its block), and its mixer and FFN or MoE run over the model
axis.  ``stack_prefill`` and ``stack_decode`` take ``par`` the same way,
each block viewed through ``par.view``, and keep each layer's cache as
this rank's part of the reference's ``_cache_shardings``
(``layers``' docstring): an attention layer's by kv heads or by slots,
a cross-attention layer's by kv heads or, when they do not split, by
its image tokens (slots, as an attention layer's), a Mamba layer's
state by its channels.  ``init_cache`` and
``precompute_cross_cache`` build the same parts.

Under sequence parallelism (``par.sp``, a ``Parallel.for_sequence``
copy) ``x`` between the blocks is this rank's block of positions: the
norms (their scales through *f*), the ``xgate`` (through *f* too) and
the residual adds run on the block, each mixer and FFN or MoE gathers
the sequence where it starts and reduce-scatters its sums where it
ends, and under ``cfg.remat`` the block is what a checkpointed period
keeps.  ``stack_prefill`` builds each cache from the gathered
sequence, so the caches are the plain tensor-parallel ones;
``stack_decode``'s one position runs whole on every rank.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import REMAT_POLICIES
from ..parallel.sharding import shard_activation as shard
from . import layers as L
from . import mamba as M
from . import moe as MOE

__all__ = ["AUX_KEYS", "KINDS", "pattern_for", "n_periods", "Block",
           "block_axes", "Stack", "stack_init", "stack_apply", "init_cache",
           "precompute_cross_cache", "stack_prefill", "_ring_positions",
           "stack_decode"]

#: the auxiliary sums a forward returns (the MoE blocks' losses)
AUX_KEYS = ("aux_loss", "z_loss", "drop_frac")
#: the block kinds of the reference
KINDS = ("attn_ffn", "attn_moe", "xattn_ffn", "mamba", "mamba_ffn",
         "mamba_moe")


def pattern_for(cfg) -> tuple[str, ...]:
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.family == "mamba":
        return ("mamba",)
    if cfg.family == "vision":
        pat = ["attn_ffn"] * cfg.xattn_period
        pat[cfg.xattn_pos] = "xattn_ffn"
        return tuple(pat)
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
    """The block kind of every layer."""
    pat = pattern_for(cfg)
    for kind in pat:
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; the reference "
                             f"has {KINDS}")
    return [pat[i % len(pat)] for i in range(n_periods(cfg) * len(pat))]


class Block(nn.Module):
    """One block: ``ln1`` and its mixer (``attn``, with the scalar
    ``xgate`` for cross-attention, or ``mamba``), then ``ln2`` and
    ``ffn`` or ``moe`` for the ``_ffn`` / ``_moe`` kinds."""

    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.kind = kind
        self.ln1 = L.RMSNorm(cfg.d_model, device=device)
        if kind.startswith("mamba"):
            self.mamba = M.Mamba(cfg, device=device)
        else:
            self.attn = L.Attention(cfg, device=device)
            if kind.startswith("xattn"):
                self.xgate = L.param((), torch.float32, device, fill=0.0)
        if kind.endswith("_ffn"):
            self.ln2 = L.RMSNorm(cfg.d_model, device=device)
            self.ffn = L.FFN(cfg, device=device)
        elif kind.endswith("_moe"):
            self.ln2 = L.RMSNorm(cfg.d_model, device=device)
            self.moe = MOE.MoE(cfg, device=device)


def block_axes(cfg, kind: str) -> dict:
    """The logical axes of a ``Block``'s parameters (the reference's
    ``_block_init`` axes, one layer: no ``"layers"`` axis)."""
    a = {"ln1": dict(L.NORM_AXES)}
    if kind.startswith("mamba"):
        a["mamba"] = dict(M.MAMBA_AXES)
    else:
        a["attn"] = L.attn_axes(cfg)
        if kind.startswith("xattn"):
            a["xgate"] = ()
    if kind.endswith("_ffn"):
        a["ln2"], a["ffn"] = dict(L.NORM_AXES), L.ffn_axes(cfg)
    elif kind.endswith("_moe"):
        a["ln2"], a["moe"] = dict(L.NORM_AXES), MOE.moe_axes(cfg)
    return a


class Stack(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, kind, device=device)
                                    for kind in _kinds(cfg))


def stack_init(stack: Stack, cfg, generator: torch.Generator) -> None:
    """Draw every block's random parameters in place, layer by layer:
    the mixer, then the FFN or MoE (an ``xgate`` keeps its 0)."""
    for blk in stack.blocks:
        if blk.kind.startswith("mamba"):
            M.mamba_init(blk.mamba, cfg, generator)
        else:
            L.attn_init(blk.attn, cfg, generator)
        if blk.kind.endswith("_ffn"):
            L.ffn_init(blk.ffn, cfg, generator)
        elif blk.kind.endswith("_moe"):
            MOE.moe_init(blk.moe, cfg, generator)


def _gated(blk: Block, mix: torch.Tensor, par=None) -> torch.Tensor:
    """``tanh(xgate)`` in float32, cast to the mix's dtype, times the
    mix in that dtype, as the reference gates cross-attention (under
    sequence parallelism the mix is this rank's block, and the gate
    goes through *f*)."""
    gate = par.copy(blk.xgate) if par is not None and par.sp else blk.xgate
    return torch.tanh(gate).to(mix.dtype) * mix


def _channel_mix(blk: Block, cfg, x: torch.Tensor, par=None):
    """``x + ffn_or_moe(ln2(x))`` and the MoE's aux dict (None for an
    FFN or a bare ``mamba`` block, which has no channel mix)."""
    if blk.kind == "mamba":
        return x, None
    h = L.norm(blk.ln2, x, cfg.norm_eps, par)
    if blk.kind.endswith("_ffn"):
        return x + L.ffn_apply(blk.ffn, cfg, h, par), None
    y, aux = MOE.moe_apply(blk.moe, cfg, h, par)
    return x + y, aux


def _block_apply(blk: Block, cfg, x: torch.Tensor, positions, img,
                 par=None):
    """One block's full-sequence forward: ``(x, aux or None)``."""
    h = L.norm(blk.ln1, x, cfg.norm_eps, par)
    if blk.kind.startswith("xattn"):
        mix = _gated(blk, L.attn_apply(blk.attn, cfg, h, positions,
                                       kv_src=img, causal=False, par=par),
                     par)
    elif blk.kind.startswith("attn"):
        mix = L.attn_apply(blk.attn, cfg, h, positions, par=par)
    else:
        mix = M.mamba_apply(blk.mamba, cfg, h, par)
    return _channel_mix(blk, cfg, x + mix, par)


def _period_apply(blocks, cfg, x: torch.Tensor, aux: dict, positions,
                  img, par=None):
    """The blocks of one pattern period, the aux sums carried through;
    under ``par`` each block's FSDP leaves are gathered here, inside
    the period's checkpointed function."""
    x = shard(x, ("batch", "seq_sp", "embed"))
    for blk in blocks:
        if par is not None:
            blk = par.view(blk)
        x, aux_b = _block_apply(blk, cfg, x, positions, img, par)
        if aux_b is not None:
            aux = {k: aux[k] + aux_b[k] for k in AUX_KEYS}
    return x, aux


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy: keep the products' outputs (the
    reference's ``checkpoint_dots``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_apply(stack: Stack, cfg, x: torch.Tensor, positions, img=None,
                par=None):
    """Full-sequence forward. x: (B, S, D); positions (B, S); img (B,
    n_img, D), the projected image tokens, for cross-attention -> (x,
    aux sums over layers, float32 scalars, summed in layer order).
    Under autograd each pattern period runs under ``cfg.remat``;
    ``par`` (a sharded model's) runs it over the model's mesh, ``x``
    this rank's block of positions under sequence parallelism."""
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"remat {cfg.remat!r}; the reference has "
                         f"{REMAT_POLICIES}")
    aux = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    period = len(pattern_for(cfg))
    blocks = list(stack.blocks)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    for i in range(0, len(blocks), period):
        args = (blocks[i:i + period], cfg, x, aux, positions, img, par)
        if remat == "none":
            x, aux = _period_apply(*args)
        elif remat == "full":
            x, aux = checkpoint(_period_apply, *args, use_reentrant=False)
        else:
            x, aux = checkpoint(
                _period_apply, *args, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _dots_policy))
    return x, aux


def _cross_cache(cfg, batch: int, *, device=None, par=None) -> dict:
    K, slots = cfg.n_kv_heads, cfg.n_img_tokens
    if par is not None and par.tp > 1 and par.kv_cache == "heads":
        K //= par.tp
    elif par is not None and par.tp > 1 and par.kv_cache == "seq":
        slots = -(-slots // par.tp)
    shape = (batch, slots, K, cfg.d_head)
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for name in ("k", "v")}


def init_cache(cfg, batch: int, max_len: int, *, device=None,
               par=None) -> list:
    """One cache a layer, zeros: ``{"h", "conv"}`` for a Mamba block, the
    image tokens' ``{"k", "v"}`` (B, n_img_tokens, K, dh) for
    cross-attention, an attention cache (a ring's ``slot_pos`` −1)
    otherwise.  Over a model axis (``par``) each is this rank's part of
    it, ``batch`` the rows this rank holds."""
    def one(kind):
        if kind.startswith("xattn"):
            return _cross_cache(cfg, batch, device=device, par=par)
        if kind.startswith("attn"):
            return L.init_attn_cache(cfg, batch, max_len, device=device,
                                     par=par)
        return M.init_mamba_cache(cfg, batch, device=device, par=par)

    return [one(kind) for kind in _kinds(cfg)]


def _cross_kv(attn: L.Attention, cfg, img: torch.Tensor, par=None) -> dict:
    """A cross-attention layer's cache from the projected image tokens:
    ``img @ wk`` and ``img @ wv`` in the compute dtype, (B, n_img, K,
    dh).  As in the reference, no ``kn`` qk-norm is applied here, though
    ``attn_apply``'s keys get it (ROADMAP queue C).  Over a model axis
    (``par``) this rank's kv heads when they split, else all of them on
    its block of the image tokens (``L.slot_block``)."""
    k, v = L._project_kv(attn, cfg, img, par)
    K = cfg.n_kv_heads
    k, v = L.cache_kv_heads(par, k, K), L.cache_kv_heads(par, v, K)
    if par is not None and par.tp > 1 and par.kv_cache == "seq":
        k, v = L.slot_block(par, k), L.slot_block(par, v)
    return {"k": k, "v": v}


def precompute_cross_cache(stack: Stack, cfg, cache: list,
                           img: torch.Tensor, par=None) -> list:
    """``cache`` with every cross-attention layer's entry filled from the
    projected image tokens ``img`` (B, n_img, D); the other layers'
    entries are the same objects.  ``par``: a sharded model's, its
    rank's heads."""
    return [_cross_kv(_view(blk, par).attn, cfg, img, par)
            if blk.kind.startswith("xattn") else c
            for blk, c in zip(stack.blocks, cache, strict=True)]


def _view(blk: Block, par):
    return blk if par is None else par.view(blk)


def _ring_positions(S: int, W: int, B: int, device=None) -> torch.Tensor:
    """Absolute positions of ring slots after prefilling S tokens: slot
    j holds position p with p % W == j and p in [S-W, S)."""
    base = torch.arange(W, device=device)
    start = S - W
    pos = start + (base - (start % W)) % W
    return pos.to(torch.int32).expand(B, W).contiguous()


def _attn_cache(k: torch.Tensor, v: torch.Tensor, max_len: int,
                W: int, cfg, par=None) -> dict:
    """The decode cache of one attention layer from its prefill k, v
    (B, S, K', dh): the last W positions rolled into ring order with
    their ``slot_pos`` when ``W``, else the whole prompt grown to
    ``max_len`` slots.  Over a model axis (``par``) this rank's part:
    its kv heads, or all of them cut to its block of slots (``max_len``
    first rounded up to a multiple of tp)."""
    seq = par is not None and par.tp > 1 and par.kv_cache == "seq"
    k = L.cache_kv_heads(par, k, cfg.n_kv_heads)
    v = L.cache_kv_heads(par, v, cfg.n_kv_heads)
    B, S = k.shape[:2]
    if not W:
        if seq:
            max_len = -(-max_len // par.tp) * par.tp
        pad = (0, 0, 0, 0, 0, max_len - S)
        cache = {"k": torch.nn.functional.pad(k, pad),
                 "v": torch.nn.functional.pad(v, pad)}
    elif S >= W:
        # ring invariant: slot j holds position p, p % W == j
        cache = {"k": torch.roll(k[:, -W:], S % W, 1),
                 "v": torch.roll(v[:, -W:], S % W, 1),
                 "slot_pos": _ring_positions(S, W, B, k.device)}
    else:
        pad = (0, 0, 0, 0, 0, W - S)
        sp = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
        sp[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
        cache = {"k": torch.nn.functional.pad(k, pad),
                 "v": torch.nn.functional.pad(v, pad), "slot_pos": sp}
    if seq:
        cache["k"] = L.slot_block(par, cache["k"])
        cache["v"] = L.slot_block(par, cache["v"])
    return cache


def stack_prefill(stack: Stack, cfg, x: torch.Tensor, positions, img=None,
                  max_len=None, par=None):
    """Forward that also returns the decode cache: ``(hidden, [cache of
    each layer])``.  Attention layers keep their K/V with room for
    ``max_len`` positions (a ring of the window when it is shorter);
    cross-attention layers the image tokens' K/V; Mamba layers the
    final recurrent and conv state.  ``par`` (a sharded model's) runs
    it over the model's mesh, each cache this rank's part (``x`` and
    the hidden state returned this rank's block of positions under
    sequence parallelism, the caches built from the whole
    sequence)."""
    S = par.seq_len if par is not None and par.sp else x.shape[1]
    max_len = max(max_len or 0, S)
    W = cfg.sliding_window if (cfg.sliding_window and
                               cfg.sliding_window < max_len) else 0
    caches = []
    period = len(pattern_for(cfg))
    for i, blk in enumerate(stack.blocks):
        if i % period == 0:
            x = shard(x, ("batch", "seq_sp", "embed"))
        blk = _view(blk, par)
        h = L.norm(blk.ln1, x, cfg.norm_eps, par)
        if blk.kind.startswith("xattn"):
            mix = _gated(blk, L.attn_apply(blk.attn, cfg, h, positions,
                                           kv_src=img, causal=False,
                                           par=par), par)
            caches.append(_cross_kv(blk.attn, cfg, img, par))
        elif blk.kind.startswith("attn"):
            mix, k, v = L._attn(blk.attn, cfg, h, positions, par=par)
            caches.append(_attn_cache(k, v, max_len, W, cfg, par))
        else:
            mix, st = M.mamba_prefill(blk.mamba, cfg, h, par)
            caches.append(st)
        x, _ = _channel_mix(blk, cfg, x + mix, par)
    return x, caches


def stack_decode(stack: Stack, cfg, x: torch.Tensor, pos, cache: list,
                 par=None):
    """One-token decode. x: (B, 1, D); ``pos`` (B,) the new token's
    absolute position (Mamba and cross-attention blocks do not read
    it).  Returns ``(x, new cache)``; the input cache is left as it was,
    and a cross-attention layer's entry is passed on as it is.  ``par``
    (a sharded model's) runs it over the model's mesh on this rank's
    part of each cache."""
    new_cache = []
    for blk, c in zip(stack.blocks, cache, strict=True):
        blk = _view(blk, par)
        h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
        if blk.kind.startswith("xattn"):
            mix, nc = L.attn_decode(blk.attn, cfg, h, c, pos,
                                    kv_src="static", par=par)
            mix = _gated(blk, mix)
        elif blk.kind.startswith("attn"):
            mix, nc = L.attn_decode(blk.attn, cfg, h, c, pos, par=par)
        else:
            mix, nc = M.mamba_decode(blk.mamba, cfg, h, c, par)
        new_cache.append(nc)
        x, _ = _channel_mix(blk, cfg, x + mix, par)
    return x, new_cache
