"""Model substrate of the LM stack: parameter helpers, linear products,
RMSNorm, the token embedding, RoPE, attention (GQA / MQA, sliding
window, qk-norm, cross-attention over image tokens; chunked online
softmax for full sequences, a one-token core for decode), the FFN and
the output head.

The counterpart of the reference's ``models/layers.py``.  Parameters are
stored in ``cfg.param_dtype`` (float32 master copies) and cast to
``cfg.compute_dtype`` (bfloat16) per product; normalisation statistics,
attention logits and the softmax are float32.  Where the reference asks
XLA for a float32 product of bf16 operands
(``preferred_element_type=float32``), the port casts both operands to
float32 first: a bf16 x bf16 product is exact in float32, so the sums
accumulate in float32 as XLA's do.  Parameters are ``nn.Parameter``s
created without gradients, so serving builds no graph; the trainer turns
them on (``runtime.train_loop.init_state``).  The
reference's ``shard_activation`` annotations are kept at its places: a
no-op unless sharding rules are installed (the dry-run installs them,
and its counter reads the axes).  Attention is PyTorch ops tile for tile, as the
reference's jnp; no fused attention library call is on the path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import shard_activation as shard

__all__ = ["_normal", "param", "Linear", "linear_init", "linear", "RMSNorm",
           "rmsnorm", "NORM_AXES", "EMBED_AXES", "HEAD_AXES",
           "FRONTEND_AXES", "padded_vocab", "Embed", "embed_init", "embed",
           "rope", "_chunk_mask", "flash_attention", "decode_attention",
           "Attention", "attn_axes", "attn_init", "_project_qkv", "attn_apply",
           "attn_decode", "init_attn_cache", "_ACTS", "FFN", "ffn_axes", "ffn_init",
           "ffn_apply", "Head", "head_init", "mask_padded_vocab",
           "cross_entropy", "chunked_cross_entropy"]


def _normal(generator: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale²) drawn in float32 on the generator's device, then cast
    to ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def param(shape, dtype: torch.dtype, device, fill=None) -> nn.Parameter:
    """An uninitialised (or ``fill``-ed) parameter, created without a
    gradient: serving and scoring build no autograd graph.  The trainer
    enables gradients on every parameter of the model at once
    (``runtime.train_loop.init_state`` calls ``model.requires_grad_()``),
    as the reference differentiates every leaf of its tree."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """A (d_in, d_out) weight ``w``, named as the reference's dict."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.w = param((d_in, d_out), dtype, device)


def linear_init(p: Linear, generator: torch.Generator,
                scale: float | None = None) -> None:
    """N(0, scale²) with the reference's default scale d_in^-1/2."""
    d_in = p.w.shape[0]
    scale = scale if scale is not None else d_in ** -0.5
    p.w.copy_(_normal(generator, p.w.shape, scale, p.w.dtype))


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


#: the logical axes of the top-level parameters (the reference's
#: ``rmsnorm_init``, ``embed_init``, ``head_init`` and frontend axes)
NORM_AXES = {"scale": ("embed",)}
EMBED_AXES = {"table": ("vocab", "embed")}
HEAD_AXES = {"w": ("embed", "vocab")}
FRONTEND_AXES = {"w": ("none", "embed")}


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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S).  Angles
    and the rotation in float32, the result in ``x``'s dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / SWA / cross) — chunked online-softmax ("flash") core
# ---------------------------------------------------------------------------

def _chunk_mask(q_idx: torch.Tensor, kv_idx: torch.Tensor, causal: bool,
                window: int, kv_len: int) -> torch.Tensor:
    """(qc, kc) bool mask of *allowed* positions (kv_len masks padding)."""
    m = (kv_idx[None, :] < kv_len).expand(q_idx.shape[0], -1)
    if causal:
        m = m & (q_idx[:, None] >= kv_idx[None, :])
    if window > 0:
        m = m & ((q_idx[:, None] - kv_idx[None, :]) < window)
    return m


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """``q * dh^-1/2`` rounded to q's dtype, the scale first rounded to
    it too (jnp's weakly typed scalar), as the reference computes it.
    The rounded scale is a Python float: a device tensor made from a
    Python number is a host-to-device copy that stalls the host."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()
    return q * scale


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    q_chunk=1024, kv_chunk=1024) -> torch.Tensor:
    """Chunked attention with online softmax and block skipping.

    q: (B, Sq, K, G, dh) — GQA-grouped queries (G = H // K);
    k, v: (B, Skv, K, dh).  Never materialises the (Sq, Skv) scores.
    The loop over q chunks is a Python loop, each visiting only the kv
    tiles its causal / sliding-window band allows: interior tiles run
    mask-free, only boundary tiles (the causal diagonal, the window's
    edge, kv padding) apply a mask, as in the reference.  ``q_offset``
    places the queries inside the kv stream.
    """
    B, Sq0, K, G, dh = q.shape
    Skv0 = k.shape[1]
    qc = min(q_chunk, Sq0)
    kc = min(kv_chunk, Skv0)
    q_pad = (-Sq0) % qc
    kv_pad = (-Skv0) % kc
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    Sq, Skv = Sq0 + q_pad, Skv0 + kv_pad
    nq, nk = Sq // qc, Skv // kc

    qf = _scaled(q).reshape(B, nq, qc, K, G, dh)
    kf = k.reshape(B, nk, kc, K, dh)
    vf = v.reshape(B, nk, kc, K, dh)

    def tile_update(m_run, l_run, acc, q_tile, k_tile, v_tile, mask):
        """Online-softmax update with one (qc x kc) tile; mask=None for
        interior tiles (every pair allowed: no mask at all)."""
        s = torch.einsum("bqkgd,bskd->bkgqs", q_tile.float(),
                         k_tile.float())
        if mask is not None:
            s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m_run, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m_run),
                            torch.exp(m_run - m_safe), 0.0)
        l_new = l_run * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd",
                          p.to(v_tile.dtype).float(), v_tile.float())
        return m_new, l_new, acc * alpha[..., None] + pv

    def tile_is_interior(qi, ki):
        """Fully-allowed tile: every (q_idx, kv_idx) pair passes."""
        q_lo = q_offset + qi * qc
        q_hi = q_offset + (qi + 1) * qc - 1
        kv_lo, kv_hi = ki * kc, ki * kc + kc - 1
        if kv_hi >= Skv0:
            return False                         # padding tile
        if causal and kv_hi > q_lo:
            return False                         # crosses the diagonal
        if window > 0 and (q_hi - kv_lo) >= window:
            return False                         # crosses the window edge
        return True

    def tile_possible(qi, ki):
        """Any allowed pair at all? (skip entirely when not)"""
        q_lo = q_offset + qi * qc
        q_hi = q_offset + (qi + 1) * qc - 1
        kv_lo = ki * kc
        if kv_lo >= Skv0:
            return False
        if causal and kv_lo > q_hi:
            return False
        if window > 0 and (q_lo - (ki * kc + kc - 1)) >= window:
            return False
        return True

    outs = []
    for qi in range(nq):
        q_tile = qf[:, qi]
        q_idx = q_offset + qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, K, G, qc), -torch.inf, device=q.device)  # torchlint: disable=TL002 (an accumulator's fill)
        l = torch.zeros((B, K, G, qc), device=q.device)
        acc = torch.zeros((B, K, G, qc, dh), device=q.device)
        interior = [ki for ki in range(nk)
                    if tile_possible(qi, ki) and tile_is_interior(qi, ki)]
        boundary = [ki for ki in range(nk)
                    if tile_possible(qi, ki) and not tile_is_interior(qi, ki)]
        # the reference scans the contiguous interior range, then the
        # boundary tiles: the same order of updates here
        if interior:
            assert interior == list(range(interior[0], interior[-1] + 1)), \
                (qi, interior)
        for ki in interior:
            m, l, acc = tile_update(m, l, acc, q_tile, kf[:, ki], vf[:, ki],
                                    None)
        for ki in boundary:
            kv_idx = ki * kc + torch.arange(kc, device=q.device)
            mask = _chunk_mask(q_idx, kv_idx, causal, window, Skv0)
            m, l, acc = tile_update(m, l, acc, q_tile, kf[:, ki], vf[:, ki],
                                    mask)
        l = l.clamp(min=1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))
    out = torch.cat(outs, 1) if nq > 1 else outs[0]
    return out[:, :Sq0].to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid) -> torch.Tensor:
    """One-token decode against a (B, Smax, K, dh) cache.

    q: (B, 1, K, G, dh); ``valid``: (B, Smax) bool — the cache slots that
    may be attended (from positions, ring slot positions and windows).
    """
    s = torch.einsum("bokgd,bskd->bkgos", _scaled(q).float(),
                     k_cache.float())
    s = torch.where(valid[:, None, None, None], s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgos,bskd->bokgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (and ``qn``, ``kn`` with qk-norm),
    named as the reference's dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        H, K, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
        pd = cfg.param_dtype
        self.wq = Linear(D, H * dh, pd, device=device)
        self.wk = Linear(D, K * dh, pd, device=device)
        self.wv = Linear(D, K * dh, pd, device=device)
        self.wo = Linear(H * dh, D, pd, device=device)
        if cfg.qk_norm:
            self.qn = RMSNorm(dh, device=device)
            self.kn = RMSNorm(dh, device=device)


def attn_axes(cfg) -> dict:
    """The logical axes of an ``Attention``'s parameters (the
    reference's ``attn_init`` axes)."""
    a = {"wq": {"w": ("embed", "heads_q")}, "wk": {"w": ("embed", "heads_kv")},
         "wv": {"w": ("embed", "heads_kv")}, "wo": {"w": ("heads_q", "embed")}}
    if cfg.qk_norm:
        a["qn"] = a["kn"] = {"scale": ("none",)}
    return a


def attn_init(p: Attention, cfg, generator: torch.Generator) -> None:
    H, dh = cfg.n_heads, cfg.d_head
    for w in (p.wq, p.wk, p.wv):
        linear_init(w, generator)
    linear_init(p.wo, generator,
                scale=(H * dh) ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def _project_qkv(p: Attention, cfg, x, kv_src, positions,
                 use_rope: bool = True):
    """q (B, S, H, dh) from ``x``, k and v (B, S, K, dh) from ``kv_src``,
    in the compute dtype, after qk-norm and (``use_rope``, self-attention
    only) RoPE at ``positions``."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cd = cfg.compute_dtype
    q = linear(p.wq.w, x, cd).reshape(B, -1, H, dh)
    k = linear(p.wk.w, kv_src, cd).reshape(B, -1, K, dh)
    v = linear(p.wv.w, kv_src, cd).reshape(B, -1, K, dh)
    if cfg.qk_norm:
        q = rmsnorm(p.qn, q, cfg.norm_eps)
        k = rmsnorm(p.kn, k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", None, "heads_q", None))
    k = shard(k, ("batch", None, "heads_kv", None))
    v = shard(v, ("batch", None, "heads_kv", None))
    return q, k, v


def _attn(p: Attention, cfg, x, positions, *, causal=None, kv_src=None):
    """Full-sequence attention: ``(out (B, S, D), k, v)``; prefill
    keeps a self-attention layer's k and v for its cache (the reference
    projects them again).  With ``kv_src`` (B, Skv, D) it is
    cross-attention, as the reference runs it: keys and values from
    ``kv_src``, no RoPE on q or k, never causal."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    causal = cfg.causal if causal is None else causal
    cross = kv_src is not None
    q, k, v = _project_qkv(p, cfg, x, kv_src if cross else x, positions,
                           use_rope=not cross)
    q = q.reshape(B, S, K, H // K, dh)
    qc = cfg.q_chunk or min(1024, S)
    kc = cfg.kv_chunk or min(1024, k.shape[1])
    out = flash_attention(q, k, v, causal=causal and not cross,
                          window=cfg.sliding_window, q_chunk=qc,
                          kv_chunk=kc)
    out = linear(p.wo.w, out.reshape(B, S, H * dh), cfg.compute_dtype)
    return shard(out, ("batch", "seq_sp", "embed")), k, v


def attn_apply(p: Attention, cfg, x, positions, *, causal=None,
               kv_src=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D); causal
    ``None`` means ``cfg.causal``; ``kv_src`` (B, Skv, D) makes it
    cross-attention."""
    return _attn(p, cfg, x, positions, causal=causal, kv_src=kv_src)[0]


def attn_decode(p: Attention, cfg, x, cache: dict, pos, *, kv_src=None):
    """One-token decode. x: (B, 1, D); pos: (B,) absolute position of the
    new token.  Two cache layouts:

      full cache:  {"k","v"} (B, Smax, K, dh) — slot index == position;
      ring cache:  {"k","v"} (B, W, K, dh) + {"slot_pos"} (B, W) absolute
                   positions per slot (−1 = empty) — for sliding-window
                   attention the cache is only window-deep, slots recycle.

    Cross-attention (``kv_src`` not None, e.g. ``"static"``) reads the
    precomputed image cache {"k","v"} (B, n_img, K, dh) with every slot
    valid, ropes nothing and writes nothing: the cache it returns is
    the one it was given.  Returns ``(out, new_cache)``; the input cache
    is left as it was.
    """
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kv_src is not None:
        k, v = cache["k"], cache["v"]
        q = linear(p.wq.w, x, cfg.compute_dtype).reshape(B, 1, H, dh)
        if cfg.qk_norm:
            q = rmsnorm(p.qn, q, cfg.norm_eps)
        valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        new_cache = cache
    else:
        pos = torch.as_tensor(pos, device=x.device).long()  # torchlint: disable=TL002 (pos is a device tensor)
        q, kn, vn = _project_qkv(p, cfg, x, x, pos[:, None])
        ring = "slot_pos" in cache
        Smax = cache["k"].shape[1]
        # a full cache's slot is clamped into range, as
        # dynamic_update_slice clamps the reference's
        slot = pos % Smax if ring else pos.clamp(0, Smax - 1)
        rows = torch.arange(B, device=x.device)
        k = cache["k"].index_put((rows, slot), kn[:, 0])
        v = cache["v"].index_put((rows, slot), vn[:, 0])
        new_cache = {"k": k, "v": v}
        if ring:
            slot_pos = cache["slot_pos"].index_put(
                (rows, slot), pos.to(cache["slot_pos"].dtype))
            new_cache["slot_pos"] = slot_pos
            valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
            if cfg.sliding_window > 0:
                valid &= (pos[:, None] - slot_pos) < cfg.sliding_window
        else:
            idx = torch.arange(Smax, device=x.device)
            valid = idx[None, :] <= pos[:, None]
            if cfg.sliding_window > 0:
                valid &= (pos[:, None] - idx[None, :]) < cfg.sliding_window
        k = shard(k, ("batch", "kv_seq", "heads_kv", None))
        v = shard(v, ("batch", "kv_seq", "heads_kv", None))
    out = decode_attention(q.reshape(B, 1, K, H // K, dh), k, v, valid)
    out = linear(p.wo.w, out.reshape(B, 1, H * dh), cfg.compute_dtype)
    return out, new_cache


def init_attn_cache(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """One layer's self-attention cache in the compute dtype: a ring
    (``slot_pos`` −1) when the sliding window is shorter than
    ``max_len``, else full depth."""
    dtype = cfg.compute_dtype
    K, dh = cfg.n_kv_heads, cfg.d_head
    w = cfg.sliding_window
    depth = w if w and w < max_len else max_len
    cache = {"k": torch.zeros((batch, depth, K, dh), dtype=dtype,
                              device=device),
             "v": torch.zeros((batch, depth, K, dh), dtype=dtype,
                              device=device)}
    if depth != max_len:
        cache["slot_pos"] = torch.full((batch, depth), -1,
                                       dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as jnp writes it, ``x * (1 / (1 + exp(-x)))``, each
    op rounded to x's dtype (``F.silu`` rounds once, and in bfloat16
    differs from it in the last bit of ~40 % of entries)."""
    return x * (1 / (1 + torch.exp(-x)))


_ACTS = {
    "silu": _silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


class FFN(nn.Module):
    """``wi``, ``wo`` and, for a gated activation, ``wg``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, d_ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        if cfg.act in ("silu", "gelu") and cfg.family != "encoder":
            self.wg = Linear(D, d_ff, pd, device=device)
        self.wi = Linear(D, d_ff, pd, device=device)
        self.wo = Linear(d_ff, D, pd, device=device)


def ffn_axes(cfg) -> dict:
    """The logical axes of an ``FFN``'s parameters."""
    a = {"wi": {"w": ("embed", "ff")}, "wo": {"w": ("ff", "embed")}}
    if cfg.act in ("silu", "gelu") and cfg.family != "encoder":
        a["wg"] = {"w": ("embed", "ff")}
    return a


def ffn_init(p: FFN, cfg, generator: torch.Generator) -> None:
    if hasattr(p, "wg"):
        linear_init(p.wg, generator)
    linear_init(p.wi, generator)
    linear_init(p.wo, generator,
                scale=cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def ffn_apply(p: FFN, cfg, x: torch.Tensor) -> torch.Tensor:
    act = _ACTS[cfg.act]
    cd = cfg.compute_dtype
    h = linear(p.wi.w, x, cd)
    h = act(linear(p.wg.w, x, cd)) * h if hasattr(p, "wg") else act(h)
    h = shard(h, ("batch", None, "ff"))
    return shard(linear(p.wo.w, h, cd), ("batch", "seq_sp", "embed"))


# ---------------------------------------------------------------------------
# Output head / loss
# ---------------------------------------------------------------------------

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


def _chunk_nll(head_fn, hc: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor):
    """One chunk's ``(Σ masked NLL, Σ mask)``, its logits in float32."""
    logits = head_fn(hc).float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lc.long()[..., None])[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_cross_entropy(head_fn, h: torch.Tensor, labels: torch.Tensor,
                          mask=None, chunk: int = 256) -> torch.Tensor:
    """Sequence-chunked NLL, the reference's ``chunked_cross_entropy``:
    per chunk of ``chunk`` positions, project the hidden states to
    logits with ``head_fn``, take the masked NLL sum, and drop the
    logits; each chunk runs under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of the reference's
    ``@jax.checkpoint``, so backward recomputes them.  Peak logits
    memory is (B, chunk, V) instead of (B, S, V).  S is padded up to a
    multiple of ``chunk`` with label 0 and mask 0 (no mask given: ones
    over the real positions), and the sums are carried chunk by chunk in
    order, as the reference's scan carries them.  Returns the float32
    mean over the mask (at least 1)."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    mask = torch.ones((B, S), dtype=torch.float32, device=h.device) \
        if mask is None else mask.float()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[1], chunk):
        part = (head_fn, h[:, i:i + chunk], labels[:, i:i + chunk],
                mask[:, i:i + chunk])
        if torch.is_grad_enabled():
            nll_sum, m_sum = checkpoint(_chunk_nll, *part,
                                        use_reentrant=False)
        else:
            nll_sum, m_sum = _chunk_nll(*part)
        total = total + nll_sum
        count = count + m_sum
    return total / count.clamp(min=1.0)
