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

Under a model axis (``par``, a sharded model's
``parallel.tensor_parallel.Parallel``; ``None`` on one rank) each rank
holds its shard of every split parameter and the functions here run the
collectives GSPMD inserts for the reference: the vocab-parallel
embedding (out-of-shard ids masked, the rows summed over the model
group), attention over this rank's query heads (its key/value heads, or
all of them gathered over the model group when the kv heads do not
split though their weights do, then the ones its query heads read),
the column- and row-parallel FFN, and the vocab-parallel head and
cross-entropy (max and log-sum-exp over the model group; padded ids
masked by their global id).

Under sequence parallelism (``par.sp``: the residual stream is this
rank's block of positions, ``parallel.tensor_parallel``) the entry *f*
of attention and the FFN becomes ``par.seq_enter`` (the whole sequence
gathered) and the exit *g* ``par.seq_exit`` (the partial sums
reduce-scattered to each rank's block); the embedding's sum over the
model group is a reduce-scatter of the positions too.  Attention, its
keys and values (a prefill's cache) and the FFN see the whole
sequence, so their results are the plain tensor-parallel ones; the
image tokens of cross-attention are whole on every rank and keep *f*.
``norm`` applies a norm to the block with its scale through *f*.

A decode step under a model axis reads this rank's part of the cache,
laid out as ``par.kv_cache`` says (the reference's ``_cache_shardings``):

- ``"heads"`` (``K % tp == 0``): the rank's K / tp key/value heads over
  every slot; its query heads attend over them as in training.
- ``"seq"`` (``K % tp != 0``, e.g. an MQA model): all K heads over the
  rank's contiguous block of ``ceil(slots / tp)`` slots (the last block
  padded; a padded slot is never valid).  The new token's key and value
  are written only by the rank whose block holds its slot.  The query
  heads are gathered over the model group, each rank scores its slots,
  and the softmax is combined over the model group in float32: the
  maximum (a block with no valid slot then weighs nothing), the sum,
  and the weighted values reduce-scattered to each rank's query heads
  before the row-parallel ``wo``.  A full cache's slots are ``max_len``
  rounded up to a multiple of tp, so a position at or past ``max_len``
  is written to a padded slot where the reference clamps it to its last
  one: decode within ``max_len``, as ``launch.serve.generate`` does.  A
  ring cache's ``slot_pos`` stays whole on every rank, as the
  reference's ``(batch, None)`` spec keeps it.
- ``None``: the whole cache on every rank.

A cross-attention cache (the image tokens' keys and values) splits as
a self-attention cache does: by kv heads under ``"heads"``, by its
image tokens under ``"seq"`` (every one of a block's real tokens is
valid, and the softmax is combined the same way), whole under
``None``.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import shard_activation as shard

__all__ = ["_normal", "param", "Linear", "linear_init", "linear", "RMSNorm",
           "rmsnorm", "norm", "NORM_AXES", "EMBED_AXES", "HEAD_AXES",
           "FRONTEND_AXES", "padded_vocab", "Embed", "embed_init", "embed",
           "rope", "_chunk_mask", "flash_attention", "decode_attention",
           "Attention", "attn_axes", "attn_init", "_project_kv",
           "_project_qkv", "cache_kv_heads", "slot_block", "attn_apply",
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


def norm(p: RMSNorm, x: torch.Tensor, eps: float, par=None) -> torch.Tensor:
    """``rmsnorm`` of a residual stream: under sequence parallelism
    (``par.sp``) ``x`` is this rank's block of positions, and the whole
    scale goes through *f*, so its gradient sums every rank's part."""
    if par is not None and par.sp:
        p = types.SimpleNamespace(scale=par.copy(p.scale))
    return rmsnorm(p, x, eps)


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


def embed(p: Embed, tokens: torch.Tensor, compute_dtype: torch.dtype,
          par=None) -> torch.Tensor:
    """Rows of ``p.table`` for ``tokens``; over a model axis (``par``)
    the table holds this rank's block of ids, the others' rows are
    zeros, and the rows are summed over the model group (under sequence
    parallelism, reduce-scattered: this rank's block of positions)."""
    table = p.table
    # gather, then cast: the values of the reference's cast-then-gather,
    # without a compute-dtype copy of the whole table each call
    if par is None or par.tp == 1:
        return table[tokens.long()].to(compute_dtype)
    n = table.shape[0]
    ids = tokens.long() - par.tp_rank * n
    mine = (ids >= 0) & (ids < n)
    rows = torch.where(mine[..., None], table[ids.clamp(0, n - 1)], 0.0)
    rows = par.seq_exit(rows) if par.sp else par.reduce(rows)
    return rows.to(compute_dtype)


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


def _kv_weight(par, w: torch.Tensor, K: int, dh: int) -> torch.Tensor:
    """A key/value weight as a model-axis rank uses it: its shard, or the
    whole weight through *f* when the rules keep it whole (its gradient
    from this rank's heads is a part of the whole)."""
    return par.copy(w) if w.shape[1] == K * dh else w


def _local_kv(par, k: torch.Tensor, H: int, K: int) -> torch.Tensor:
    """This rank's query heads' keys (or values): ``k`` (B, S, K', dh)
    holds this rank's K / tp heads, or all K of them when K does not
    split over the model axis; rank r's query heads are r·H/tp ..
    (r+1)·H/tp - 1, and query head h reads kv head h // (H / K)."""
    if k.shape[2] != K:                      # this rank's kv heads
        return k
    hq, G = H // par.tp, H // K
    h0 = par.tp_rank * hq
    if G % hq == 0:                          # all in one kv head
        return k[:, :, h0 // G:h0 // G + 1]
    return k[:, :, torch.arange(h0, h0 + hq, device=k.device) // G]


def _project_kv(p: Attention, cfg, src, par=None):
    """k and v (B, S, K', dh) in the compute dtype from ``src`` (no
    qk-norm, no RoPE).  Over a model axis (``par``) K' is this rank's
    K / tp heads when the kv heads split, else all K of them (gathered
    over the model group when their weights split)."""
    B = src.shape[0]
    K, dh, cd = cfg.n_kv_heads, cfg.d_head, cfg.compute_dtype
    tp = par is not None and par.tp > 1
    wk, wv = p.wk.w, p.wv.w
    if tp:
        wk, wv = _kv_weight(par, wk, K, dh), _kv_weight(par, wv, K, dh)
    k, v = linear(wk, src, cd), linear(wv, src, cd)
    if tp and k.shape[-1] != K * dh and K % par.tp:
        # weights split, heads not: every rank takes all K heads
        k, v = par.gather(k, -1), par.gather(v, -1)
    return (k.reshape(B, -1, k.shape[-1] // dh, dh),
            v.reshape(B, -1, v.shape[-1] // dh, dh))


def cache_kv_heads(par, k: torch.Tensor, K: int) -> torch.Tensor:
    """``k`` (B, S, K', dh) with the kv heads a rank's decode cache
    holds: as projected on one rank or where the cache splits by kv
    heads, else all K (gathered over the model group when ``k`` holds
    this rank's K / tp)."""
    if par is None or par.tp == 1 or par.kv_cache == "heads" \
            or k.shape[2] == K:
        return k
    return par.gather(k, 2)


def slot_block(par, t: torch.Tensor, fill=0) -> torch.Tensor:
    """This rank's contiguous block of ``ceil(n / tp)`` of ``t``'s ``n``
    slots (dimension 1), the last block padded with ``fill``."""
    n = t.shape[1]
    c = -(-n // par.tp)
    pad = c * par.tp - n
    if pad:
        t = torch.cat([t, t.new_full((t.shape[0], pad, *t.shape[2:]),
                                     fill)], 1)
    return t[:, par.tp_rank * c:(par.tp_rank + 1) * c].contiguous()


def _whole_heads(par, H: int) -> bool:
    """Whether ``H`` query heads do not split over the model group
    (``H % tp``, e.g. 40 heads on 16 ranks): every rank then runs all H
    heads, its column block of ``x @ wq`` gathered over the group
    (``_project_q``), and keeps its block of the output's columns for
    the row-parallel ``wo`` (``_out_block``), the blocks ``wq`` and
    ``wo`` are cut by."""
    return par is not None and par.tp > 1 and H % par.tp != 0


def _project_q(p: Attention, cfg, x, par=None) -> torch.Tensor:
    """q (B, S, H', dh): ``x @ wq`` in the compute dtype, H' the rank's
    H / tp heads over a model axis, or all H where they do not split
    (``_whole_heads``)."""
    q = linear(p.wq.w, x, cfg.compute_dtype)
    if _whole_heads(par, cfg.n_heads):
        q = par.gather(q, -1)
    return q.reshape(*q.shape[:2], q.shape[-1] // cfg.d_head, cfg.d_head)


def _out_block(par, out: torch.Tensor, H: int) -> torch.Tensor:
    """An attention output (B, S, ...) flattened to (B, S, H'·dh) for
    ``wo``: where every rank ran all H heads (``_whole_heads``), this
    rank's block of its columns."""
    out = out.reshape(*out.shape[:2], -1)
    if _whole_heads(par, H):
        c = out.shape[-1] // par.tp
        out = out.narrow(-1, par.tp_rank * c, c)
    return out


def _project_qkv(p: Attention, cfg, x, kv_src, positions,
                 use_rope: bool = True, par=None):
    """q (B, S, H, dh) from ``x``, k and v (B, S, K, dh) from ``kv_src``,
    in the compute dtype, after qk-norm and (``use_rope``, self-attention
    only) RoPE at ``positions``.  Over a model axis (``par``), this
    rank's H / tp query heads (all H where they do not split,
    ``_project_q``), and k and v as ``_project_kv`` gives them (this
    rank's kv heads, or all K: ``_local_kv`` picks the ones its query
    heads read)."""
    tp = par is not None and par.tp > 1
    qn, kn = getattr(p, "qn", None), getattr(p, "kn", None)
    if tp and cfg.qk_norm:
        qn = types.SimpleNamespace(scale=par.copy(qn.scale))
        kn = types.SimpleNamespace(scale=par.copy(kn.scale))
    q = _project_q(p, cfg, x, par)
    k, v = _project_kv(p, cfg, kv_src, par)
    if cfg.qk_norm:
        q = rmsnorm(qn, q, cfg.norm_eps)
        k = rmsnorm(kn, k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", None, "heads_q", None))
    k = shard(k, ("batch", None, "heads_kv", None))
    v = shard(v, ("batch", None, "heads_kv", None))
    return q, k, v


def _attn(p: Attention, cfg, x, positions, *, causal=None, kv_src=None,
          par=None):
    """Full-sequence attention: ``(out (B, S, D), k, v)``; prefill
    keeps a self-attention layer's k and v for its cache (the reference
    projects them again).  With ``kv_src`` (B, Skv, D) it is
    cross-attention, as the reference runs it: keys and values from
    ``kv_src``, no RoPE on q or k, never causal.  Over a model axis
    (``par``) the rank's heads run, ``wo``'s partial products are
    summed over the model group, and k and v are ``_project_kv``'s
    heads.  Under sequence parallelism (``par.sp``) ``x`` and the output
    are this rank's block of positions, k and v the whole sequence's."""
    dh, H, K = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    causal = cfg.causal if causal is None else causal
    cross = kv_src is not None
    tp = par is not None and par.tp > 1
    if tp:
        x = par.seq_enter(x) if par.sp else par.copy(x)
        kv_src = par.copy(kv_src) if cross else None
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_src if cross else x, positions,
                           use_rope=not cross, par=par)
    kq, vq = (_local_kv(par, k, H, K), _local_kv(par, v, H, K)) \
        if tp and not _whole_heads(par, H) else (k, v)
    Hl = q.shape[2]                  # this rank's query heads
    q = q.reshape(B, S, kq.shape[2], Hl // kq.shape[2], dh)
    qc = cfg.q_chunk or min(1024, S)
    kc = cfg.kv_chunk or min(1024, kq.shape[1])
    out = flash_attention(q, kq, vq, causal=causal and not cross,
                          window=cfg.sliding_window, q_chunk=qc,
                          kv_chunk=kc)
    out = linear(p.wo.w, _out_block(par, out, H), cfg.compute_dtype)
    if tp:
        out = par.seq_exit(out) if par.sp else par.reduce(out)
    return shard(out, ("batch", "seq_sp", "embed")), k, v


def attn_apply(p: Attention, cfg, x, positions, *, causal=None,
               kv_src=None, par=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D); causal
    ``None`` means ``cfg.causal``; ``kv_src`` (B, Skv, D) makes it
    cross-attention; ``par`` runs it over a model axis."""
    return _attn(p, cfg, x, positions, causal=causal, kv_src=kv_src,
                 par=par)[0]


def _decode_attention_seq(par, q, k_cache, v_cache, valid, H: int):
    """``decode_attention`` over a sequence-split cache: q (B, 1, H /
    tp, dh) this rank's query heads (all H where they do not split,
    ``_whole_heads``); k, v (B, c, K, dh) this rank's block of slots;
    ``valid`` (B, c).  The scores of every query head over the rank's
    slots, then the softmax combined over the model group in float32
    (maximum, sum, weighted values), each rank left with its own query
    heads' output (B, 1, H / tp, dh), or its block of the output's
    H·dh columns."""
    B, _, _, dh = q.shape
    K = k_cache.shape[2]
    whole = _whole_heads(par, H)
    qa = q if whole else par.gather(q, 2)               # (B, 1, H, dh)
    s = torch.einsum("bokgd,bskd->bkgos",
                     _scaled(qa).reshape(B, 1, K, H // K, dh).float(),
                     k_cache.float())
    s = torch.where(valid[:, None, None, None], s, -torch.inf)
    m = par.max(s.amax(-1, keepdim=True))
    # a block with no valid slot scores -inf everywhere: weight 0
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = p / par.total(p.sum(-1, keepdim=True)).clamp(min=1e-30)
    out = torch.einsum("bkgos,bskd->bokgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.reshape(B, 1, H * dh) if whole else out.reshape(B, 1, H, dh)
    return par.scatter(out, 2).to(q.dtype)


def _write_slot(par, c: torch.Tensor, slot, new: torch.Tensor,
                seq: bool) -> torch.Tensor:
    """``c`` (B, n, ...) with row b's slot ``slot[b]`` set to
    ``new[b]``; under a sequence split (``seq``) ``slot`` is global and
    only the rank whose block holds it writes."""
    rows = torch.arange(c.shape[0], device=c.device)
    if not seq:
        return c.index_put((rows, slot), new)
    n = c.shape[1]
    local = slot - par.tp_rank * n
    mine = (local >= 0) & (local < n)
    at = (rows, local.clamp(0, n - 1))
    keep = mine.view(-1, *(1,) * (new.dim() - 1))
    return c.index_put(at, torch.where(keep, new, c[at]))


def attn_decode(p: Attention, cfg, x, cache: dict, pos, *, kv_src=None,
                par=None):
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
    is left as it was.  Over a model axis (``par``) the cache is this
    rank's part of it (``par.kv_cache``; see the module's docstring).
    """
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cd = cfg.compute_dtype
    tp = par is not None and par.tp > 1
    layout = par.kv_cache if tp else None
    if tp:
        x = par.copy(x)
    if kv_src is not None:
        k, v = cache["k"], cache["v"]
        qn = getattr(p, "qn", None)
        q = _project_q(p, cfg, x, par)
        if cfg.qk_norm:
            if tp:
                qn = types.SimpleNamespace(scale=par.copy(qn.scale))
            q = rmsnorm(qn, q, cfg.norm_eps)
        seq = layout == "seq"
        if seq:          # this rank's block of the image tokens
            idx = torch.arange(k.shape[1], device=x.device) \
                + par.tp_rank * k.shape[1]
            valid = (idx < cfg.n_img_tokens).expand(B, -1)
        else:
            valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                               device=x.device)
        new_cache = cache
    else:
        pos = torch.as_tensor(pos, device=x.device).long()  # torchlint: disable=TL002 (pos is a device tensor)
        q, kn, vn = _project_qkv(p, cfg, x, x, pos[:, None], par=par)
        seq = layout == "seq"
        kn, vn = cache_kv_heads(par, kn, K), cache_kv_heads(par, vn, K)
        ring = "slot_pos" in cache
        c = cache["k"].shape[1]
        if ring:
            Smax = cache["slot_pos"].shape[1]
        else:
            Smax = c * par.tp if seq else c
        # a full cache's slot is clamped into range, as
        # dynamic_update_slice clamps the reference's
        slot = pos % Smax if ring else pos.clamp(0, Smax - 1)
        k = _write_slot(par, cache["k"], slot, kn[:, 0], seq)
        v = _write_slot(par, cache["v"], slot, vn[:, 0], seq)
        new_cache = {"k": k, "v": v}
        if ring:
            slot_pos = cache["slot_pos"].index_put(
                (torch.arange(B, device=x.device), slot),
                pos.to(cache["slot_pos"].dtype))
            new_cache["slot_pos"] = slot_pos
            sp = slot_block(par, slot_pos, -1) if seq else slot_pos
            valid = (sp >= 0) & (sp <= pos[:, None])
            if cfg.sliding_window > 0:
                valid &= (pos[:, None] - sp) < cfg.sliding_window
        else:
            idx = torch.arange(c, device=x.device)
            if seq:
                idx = idx + par.tp_rank * c
            valid = idx[None, :] <= pos[:, None]
            if cfg.sliding_window > 0:
                valid &= (pos[:, None] - idx[None, :]) < cfg.sliding_window
        k = shard(k, ("batch", "kv_seq", "heads_kv", None))
        v = shard(v, ("batch", "kv_seq", "heads_kv", None))
    if seq:
        out = _decode_attention_seq(par, q, k, v, valid, H)
    else:
        if tp and not _whole_heads(par, H):
            k, v = _local_kv(par, k, H, K), _local_kv(par, v, H, K)
        Hl = q.shape[2]
        out = _out_block(par, decode_attention(
            q.reshape(B, 1, k.shape[2], Hl // k.shape[2], dh), k, v, valid),
            H)
    out = linear(p.wo.w, out.reshape(B, 1, -1), cd)
    if tp:
        out = par.reduce(out)
    return out, new_cache


def init_attn_cache(cfg, batch: int, max_len: int, *, device=None,
                    par=None) -> dict:
    """One layer's self-attention cache in the compute dtype: a ring
    (``slot_pos`` −1) when the sliding window is shorter than
    ``max_len``, else full depth.  Over a model axis (``par``) this
    rank's part of it (``par.kv_cache``): its kv heads, or its block of
    ``ceil(slots / tp)`` slots (``slot_pos`` whole); ``batch`` is the
    rows this rank holds."""
    dtype = cfg.compute_dtype
    K, dh = cfg.n_kv_heads, cfg.d_head
    w = cfg.sliding_window
    depth = w if w and w < max_len else max_len
    slots = depth
    layout = par.kv_cache if par is not None and par.tp > 1 else None
    if layout == "heads":
        K //= par.tp
    elif layout == "seq":
        slots = -(-depth // par.tp)
    cache = {"k": torch.zeros((batch, slots, K, dh), dtype=dtype,
                              device=device),
             "v": torch.zeros((batch, slots, K, dh), dtype=dtype,
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


def ffn_apply(p: FFN, cfg, x: torch.Tensor, par=None) -> torch.Tensor:
    """The FFN; over a model axis (``par``) ``wi`` / ``wg`` are
    column-parallel and ``wo`` row-parallel, its partial products
    summed over the model group (under sequence parallelism ``x`` and
    the output are this rank's block of positions: the sequence
    gathered on entry, the sums reduce-scattered on exit)."""
    act = _ACTS[cfg.act]
    cd = cfg.compute_dtype
    sp = par is not None and par.sp
    if par is not None:
        x = par.seq_enter(x) if sp else par.copy(x)
    h = linear(p.wi.w, x, cd)
    h = act(linear(p.wg.w, x, cd)) * h if hasattr(p, "wg") else act(h)
    h = shard(h, ("batch", None, "ff"))
    out = linear(p.wo.w, h, cd)
    if par is not None:
        out = par.seq_exit(out) if sp else par.reduce(out)
    return shard(out, ("batch", "seq_sp", "embed"))


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


def mask_padded_vocab(logits: torch.Tensor, vocab: int,
                      offset: int = 0) -> torch.Tensor:
    """Padded ids (global id ``offset + i`` at or past ``vocab``) to
    -1e9; ``offset`` places a vocab-parallel shard of the logits.  A
    vocabulary with padded ids is masked in every shard, those without
    one too (they add zeros), so that every rank of a model group runs
    the same operators."""
    if padded_vocab(vocab) == vocab:
        return logits
    v_pad = logits.shape[-1]
    live = torch.arange(offset, offset + v_pad, device=logits.device) < vocab
    return logits + torch.where(live, 0.0, -1e9).to(logits.dtype)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               par=None) -> torch.Tensor:
    """Float32 ``logsumexp - gold`` a position; over a model axis the
    logits are this rank's block of ids, the maximum, the sum of
    exponentials and the gold logit taken over the model group."""
    logits = logits.float()
    if par is None or par.tp == 1:
        logz = torch.logsumexp(logits, -1)
        return logz - logits.gather(-1, labels.long()[..., None])[..., 0]
    n = logits.shape[-1]
    m = par.max(logits.amax(-1))
    logz = m + torch.log(par.reduce(torch.exp(logits - m[..., None])
                                    .sum(-1)))
    ids = labels.long() - par.tp_rank * n
    mine = (ids >= 0) & (ids < n)
    gold = logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return logz - par.reduce(torch.where(mine, gold, 0.0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None, par=None) -> torch.Tensor:
    """Mean token NLL in float32. logits: (B, S, V), or a model-axis
    rank's vocab block of them (``par``); labels: (B, S)."""
    nll = _token_nll(logits, labels, par)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _chunk_nll(head_fn, hc: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor, par=None):
    """One chunk's ``(Σ masked NLL, Σ mask)``, its logits in float32."""
    return (_token_nll(head_fn(hc), lc, par) * mc).sum(), mc.sum()


def chunked_cross_entropy(head_fn, h: torch.Tensor, labels: torch.Tensor,
                          mask=None, chunk: int = 256,
                          par=None) -> torch.Tensor:
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
    mean over the mask (at least 1).  Over a model axis (``par``)
    ``head_fn`` gives this rank's vocab block of the logits."""
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
                mask[:, i:i + chunk], par)
        if torch.is_grad_enabled():
            nll_sum, m_sum = checkpoint(_chunk_nll, *part,
                                        use_reentrant=False)
        else:
            nll_sum, m_sum = _chunk_nll(*part)
        total = total + nll_sum
        count = count + m_sum
    return total / count.clamp(min=1.0)
