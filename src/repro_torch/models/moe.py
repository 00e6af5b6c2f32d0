"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch.

The counterpart of the reference's ``models/moe.py``.  Each batch row is
a dispatch group: each token's k expert choices get a position in their
expert from a running one-hot cumsum over the (S·k) dispatch order, and
choices past an expert's capacity C are dropped (their gate mass is not
combined; the residual carries the token).  Slot tables (token, valid,
gate per (expert, slot)) are built by an indexed write of the kept
choices, tokens are gathered into (B, E, C, D) expert buffers, the
experts run as batched products in the compute dtype, and each slot's
gated output is added back to its token.  The reference's expert
sharding layouts (``cfg.moe.layout``) run the same way on one card; its
``shard_activation`` annotations are kept at its places (no-ops unless
sharding rules are installed).
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import shard_activation as shard
from .layers import _ACTS, _normal, param

__all__ = ["MoE", "moe_axes", "moe_init", "_capacity", "_top_k", "moe_apply"]


class MoE(nn.Module):
    """``router`` (D, E) float32 and the experts' ``wg``, ``wi`` (E, D, F)
    and ``wo`` (E, F, D), named as the reference's dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        pd = cfg.param_dtype
        self.router = param((D, E), torch.float32, device)
        self.wg = param((E, D, F), pd, device)
        self.wi = param((E, D, F), pd, device)
        self.wo = param((E, F, D), pd, device)


def moe_axes(cfg) -> dict:
    """The logical axes of a ``MoE``'s parameters: experts over the
    model axis for the ``"ep"`` layout, else the FFN width."""
    ep = cfg.moe.layout == "ep"
    e_ax = "experts" if ep else "none"
    f_ax = "none" if ep else "ff"
    return {"router": ("none", "none"), "wg": (e_ax, "embed", f_ax),
            "wi": (e_ax, "embed", f_ax), "wo": (e_ax, f_ax, "embed")}


def moe_init(p: MoE, cfg, generator: torch.Generator) -> None:
    D, F = cfg.d_model, cfg.d_ff
    g = generator
    p.router.copy_(_normal(g, p.router.shape, D ** -0.5, torch.float32))
    p.wg.copy_(_normal(g, p.wg.shape, D ** -0.5, p.wg.dtype))
    p.wi.copy_(_normal(g, p.wi.shape, D ** -0.5, p.wi.dtype))
    p.wo.copy_(_normal(g, p.wo.shape, F ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                       p.wo.dtype))


def _capacity(cfg, tokens_per_group: int) -> int:
    """Slots an expert has in a group: the reference's float floor
    division, copied as it stands."""
    m = cfg.moe
    c = int(-(-tokens_per_group * m.top_k * m.capacity_factor //
              m.num_experts))
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, largest first, the lower index
    first among equal values (a stable descending sort keeps it)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: MoE, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux) with aux = {aux_loss, z_loss,
    drop_frac}, float32 scalars."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(cfg, S)
    cd = cfg.compute_dtype
    act = _ACTS[cfg.act]
    dev = x.device

    logits = x.float() @ p.router                          # (B, S, E)
    probs = torch.softmax(logits, -1)
    gates, choice = _top_k(probs, K)                       # (B, S, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    # position-in-expert via one-hot cumsum over the (S*K) dispatch order
    # one-hot by comparison: F.one_hot reads its input's minimum back to
    # the host on the CPU, and decomposes differently on each device
    oh = (choice[..., None] == torch.arange(E, device=dev)).to(torch.int32)
    oh_flat = oh.reshape(B, S * K, E)
    pos_flat = torch.cumsum(oh_flat, 1, dtype=torch.int32) - oh_flat
    pos = (pos_flat.reshape(B, S, K, E) * oh).sum(-1)      # (B, S, K)
    valid = pos < C

    # slot tables by an indexed write (the reference's scatter with
    # mode="drop"): kept (expert, slot) pairs are distinct within a group,
    # and dropped choices are masked to a spare slot C that is cut off,
    # so the write needs no host sync
    b_idx = torch.arange(B, device=dev)[:, None, None].expand(B, S, K)
    tok = torch.arange(S, device=dev)[None, :, None].expand(B, S, K)
    at = (b_idx, choice, torch.where(valid, pos, C).long())
    slot_tok = torch.zeros((B, E, C + 1), dtype=torch.long, device=dev)
    slot_tok.index_put_(at, tok)
    slot_valid = torch.zeros((B, E, C + 1), dtype=torch.bool, device=dev)
    slot_valid.index_put_(at, valid)
    slot_gate = torch.zeros((B, E, C + 1), dtype=torch.float32, device=dev)
    slot_gate.index_put_(at, gates)
    slot_tok, slot_valid, slot_gate = (slot_tok[..., :C],
                                       slot_valid[..., :C],
                                       slot_gate[..., :C])

    # gather tokens into expert buffers
    rows = torch.arange(B, device=dev)[:, None, None]
    buf = x[rows, slot_tok]                                # (B, E, C, D)
    buf = torch.where(slot_valid[..., None], buf, 0.0).to(cd)
    ep = m.layout == "ep"
    buf = shard(buf, ("batch", "experts" if ep else None, None, None))

    # expert FFN (batched products)
    h = torch.einsum("becd,edf->becf", buf, p.wi.to(cd))
    hg = torch.einsum("becd,edf->becf", buf, p.wg.to(cd))
    h = act(hg) * h
    h = shard(h, ("batch", "experts" if ep else None, None,
                  None if ep else "ff"))
    y = torch.einsum("becf,efd->becd", h, p.wo.to(cd))     # (B, E, C, D)
    y = shard(y, ("batch", "experts" if ep else None, None, None))

    # combine: weight each slot's output by its gate, then add it back to
    # its token position
    contrib = y * slot_gate[..., None].to(cd)
    flat = (slot_tok + torch.arange(B, device=dev)[:, None, None] * S
            ).reshape(-1)
    out = torch.zeros((B * S, D), dtype=cd, device=dev).index_add_(
        0, flat, contrib.reshape(-1, D)).reshape(B, S, D)
    out = shard(out, ("batch", "seq_sp", "embed"))

    # aux losses (Switch-style load balance + router z-loss)
    frac_tok = oh.float().sum(2).mean((0, 1))                # f_e
    frac_prob = probs.mean((0, 1))                           # p_e
    aux = E * torch.sum(frac_tok * frac_prob) * m.aux_loss
    z = torch.mean(torch.logsumexp(logits, -1) ** 2) * m.router_z_loss
    drop = 1.0 - valid.float().mean()
    return out, {"aux_loss": aux, "z_loss": z, "drop_frac": drop}
