"""Mamba-1 (S6) block: in-proj → causal depthwise conv → selective scan.

The counterpart of the reference's ``models/mamba.py``.  The reference
runs its sequence scan as a chunked associative scan in jnp; the port
runs the same function, ``h_t = exp(dt_t·A)⊙h_{t-1} + (dt_t·x_t)⊗B_t``,
``y_t = h_t·C_t``, through ``ops.selective_scan``: on the card one
launch of the hand-written B7 kernel per block and sequence, on the CPU
its plain time-step loop.  Decode is the O(1) recurrence in plain
PyTorch (no kernel in the reference either) with a (d_conv-1)-deep
convolution cache.  The reference's ``shard_activation`` annotations
are kept at its places (no-ops unless sharding rules are installed).

Over a model axis (``par``) each rank holds its block of the
``d_inner`` channels (``mamba_inner``): ``in_proj`` is column-parallel
with the same channels of ``x`` and of ``z`` (``MAMBA_AXES`` names its
two interleaved groups), the conv, ``dt_proj``, ``dt_bias``, ``A_log``
and ``D_skip`` are the channels' own, ``x_proj`` is row-parallel (its
partial products summed over the model group before the dt / B / C
split, and the gradient of that sum summed back: every rank's channels
read all of dt_low, B and C), B7 and its backward run on the rank's
``d_inner / tp`` channels, and ``out_proj`` is row-parallel.  Prefill
and decode run the same way, and the decode state is the rank's
channels of it: ``h`` (B, d_inner / tp, N) and ``conv`` (B, d_conv - 1,
d_inner / tp), as the reference's ``_cache_shardings`` split them.
Under sequence parallelism (``par.sp``) the block's input and output
are this rank's block of positions: the sequence is gathered on entry
(``par.seq_enter``), so the conv and B7 see every position on the
rank's channels, and ``out_proj``'s partial sums are reduce-scattered
to the block on exit (``par.seq_exit``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..parallel.sharding import Axes
from ..parallel.sharding import shard_activation as shard
from .layers import _normal, linear, param

__all__ = ["Mamba", "MAMBA_AXES", "mamba_init", "softplus", "_ssm_inputs",
           "_causal_depthwise_conv", "_mamba_fwd", "mamba_apply",
           "mamba_prefill", "init_mamba_cache", "mamba_decode"]


class Mamba(nn.Module):
    """One block's parameters, named as the reference's dict.  The
    deterministic ones are set here (``conv_b`` zeros, ``A_log`` =
    log(1..N) over d_in, ``D_skip`` ones); ``mamba_init`` draws the
    rest."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        m = cfg.mamba
        D, d_in, N, R = cfg.d_model, m.expand * cfg.d_model, m.d_state, \
            cfg.dt_rank
        pd = cfg.param_dtype
        self.in_proj = param((D, 2 * d_in), pd, device)
        self.conv_w = param((m.d_conv, d_in), pd, device)
        self.conv_b = param((d_in,), pd, device, fill=0.0)
        self.x_proj = param((d_in, R + 2 * N), pd, device)
        self.dt_proj = param((R, d_in), pd, device)
        self.dt_bias = param((d_in,), torch.float32, device)
        # log in float64, rounded once: the same bits on every device
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float64))
        self.A_log = nn.Parameter(
            a_log.float().to(device).expand(d_in, N).contiguous(),
            requires_grad=False)
        self.D_skip = param((d_in,), torch.float32, device, fill=1.0)
        self.out_proj = param((d_in, D), pd, device)


#: the logical axes of a ``Mamba``'s parameters (the reference's
#: ``mamba_init`` axes); ``in_proj``'s second dimension holds ``x`` and
#: ``z``, two groups a model-axis shard takes the same channels of
MAMBA_AXES = {
    "in_proj": Axes(("embed", "mamba_inner"), groups=(1, 2)),
    "conv_w": ("none", "mamba_inner"),
    "conv_b": ("mamba_inner",),
    "x_proj": ("mamba_inner", "none"),
    "dt_proj": ("none", "mamba_inner"),
    "dt_bias": ("mamba_inner",),
    "A_log": ("mamba_inner", "none"),
    "D_skip": ("mamba_inner",),
    "out_proj": ("mamba_inner", "embed"),
}


def mamba_init(p: Mamba, cfg, generator: torch.Generator) -> None:
    """Draw the block's random parameters in place: normal projections
    and conv taps at the reference's scales, and ``dt_bias`` so that
    ``softplus(dt_bias)`` spans [1e-3, 1e-1] (the paper's init:
    ``dt = exp(u·(log 0.1 − log 1e-3) + log 1e-3)``, u ~ U[0, 1), and
    ``bias = dt + log(−expm1(−dt))``, softplus's inverse)."""
    m = cfg.mamba
    D, d_in, R = cfg.d_model, m.expand * cfg.d_model, cfg.dt_rank
    g = generator
    p.in_proj.copy_(_normal(g, p.in_proj.shape, D ** -0.5, p.in_proj.dtype))
    p.conv_w.copy_(_normal(g, p.conv_w.shape, m.d_conv ** -0.5,
                           p.conv_w.dtype))
    p.x_proj.copy_(_normal(g, p.x_proj.shape, d_in ** -0.5, p.x_proj.dtype))
    p.dt_proj.copy_(_normal(g, p.dt_proj.shape, R ** -0.5, p.dt_proj.dtype))
    p.out_proj.copy_(_normal(g, p.out_proj.shape,
                             d_in ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                             p.out_proj.dtype))
    u = torch.rand((d_in,), generator=g, dtype=torch.float32,
                   device=g.device)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    p.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(v, 0)``, written out as
    ``max(v, 0) + log1p(exp(-|v|))``.  (``F.softplus`` computes
    ``log1p(exp(v))`` below its threshold of 20 and may differ from this
    in the last bit.)"""
    return v.clamp(min=0) + torch.log1p(torch.exp(-v.abs()))


def _ssm_inputs(p: Mamba, cfg, x_conv: torch.Tensor, par=None):
    """x_conv: (..., d_in) -> dt (..., d_in), B/C (..., N), float32 (the
    reference computes these products in float32, not the compute
    dtype).  Over a model axis ``x_proj``'s partial products are summed
    over the model group, and so is their gradient."""
    R, N = cfg.dt_rank, cfg.mamba.d_state
    bcd = x_conv.float() @ p.x_proj.float()
    if par is not None:
        bcd = par.copy(par.reduce(bcd))
    dt_low, b_ssm, c_ssm = torch.split(bcd, [R, N, N], dim=-1)
    dt = softplus(dt_low @ p.dt_proj.float() + p.dt_bias)
    return dt, b_ssm, c_ssm


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d_in); w: (k, d_in) -> (B, S, d_in), causal.

    The reference left-pads by k-1 and cross-correlates (no flip) with
    ``w`` as (k, 1, d_in) HIO: ``out[t] = Σ_j xp[t + j]·w[j] + b``, so
    ``w[k-1]`` meets the current step and ``w[0]`` the oldest.  Written
    as k shifted products (elementwise, float32: no cuDNN, no TF32),
    the tap order kept; the decode path's window sum is the same sum.
    """
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:S] * w[0]
    for j in range(1, k):
        out = out + xp[:, j:j + S] * w[j]
    return out + b


def _mamba_fwd(p: Mamba, cfg, x: torch.Tensor, par=None):
    m = cfg.mamba
    cd = cfg.compute_dtype
    sp = par is not None and par.sp
    if par is not None:
        x = par.seq_enter(x) if sp else par.copy(x)
    S = x.shape[1]
    xz = linear(p.in_proj, x, cd)
    x_part, z = xz.chunk(2, dim=-1)
    x_part = shard(x_part, ("batch", None, "mamba_inner"))
    x_conv = F.silu(_causal_depthwise_conv(
        x_part.float(), p.conv_w.float(), p.conv_b.float()))
    dt, b_ssm, c_ssm = _ssm_inputs(p, cfg, x_conv, par)
    a = -torch.exp(p.A_log)
    # B7 takes contiguous operands; B and C are views into one product
    y, h_final = ops.selective_scan(x_conv, dt, b_ssm.contiguous(),
                                    c_ssm.contiguous(), a)
    y = y + x_conv * p.D_skip
    y = (y * F.silu(z.float())).to(cd)
    y = shard(y, ("batch", None, "mamba_inner"))
    out = linear(p.out_proj, y, cd)
    if par is not None:
        out = par.seq_exit(out) if sp else par.reduce(out)
    out = shard(out, ("batch", "seq_sp", "embed"))
    conv_state = x_part[:, S - (m.d_conv - 1):].float()
    return out, h_final, conv_state


def mamba_apply(p: Mamba, cfg, x: torch.Tensor, par=None) -> torch.Tensor:
    """Full-sequence Mamba block. x: (B, S, D) -> (B, S, D); ``par``
    runs it over a model axis."""
    return _mamba_fwd(p, cfg, x, par)[0]


def mamba_prefill(p: Mamba, cfg, x: torch.Tensor, par=None):
    """Forward + decode state: returns ``(out, {"h", "conv"})``; ``par``
    runs it over a model axis, the state this rank's channels.

    The conv cache holds the last d_conv-1 inputs, so a prompt must have
    at least that many tokens: the reference keeps a shorter cache that
    its decode step cannot take; the port refuses it here."""
    k1 = cfg.mamba.d_conv - 1
    S = par.seq_len if par is not None and par.sp else x.shape[1]
    if S < k1:
        raise ValueError(f"mamba_prefill: a prompt of {S} tokens "
                         f"is shorter than d_conv - 1 = {k1}, the depth "
                         f"of the decode cache")
    out, h, conv = _mamba_fwd(p, cfg, x, par)
    return out, {"h": h, "conv": conv}


def init_mamba_cache(cfg, batch: int, *, device=None, par=None) -> dict:
    """Zeros; over a model axis (``par``) this rank's channels."""
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    if par is not None:
        d_in //= par.pieces("mamba_inner")
    return {"h": torch.zeros((batch, d_in, m.d_state), device=device),
            "conv": torch.zeros((batch, m.d_conv - 1, d_in),
                                device=device)}


def mamba_decode(p: Mamba, cfg, x: torch.Tensor, cache: dict, par=None):
    """One-token recurrence. x: (B, 1, D); cache: {"h", "conv"}.
    Returns ``(out (B, 1, D), new cache)``; ``par`` runs it over a
    model axis on this rank's channels."""
    cd = cfg.compute_dtype
    if par is not None:
        x = par.copy(x)
    xz = linear(p.in_proj, x, cd)                       # (B, 1, 2·d_in)
    x_part, z = xz.chunk(2, dim=-1)
    x1 = x_part[:, 0].float()                           # (B, d_in)
    window = torch.cat([cache["conv"], x1[:, None, :]], dim=1)
    # the last row of the prefill conv: Σ_j window[j]·w[j] + b
    x_conv = F.silu((window * p.conv_w.float()).sum(1) + p.conv_b.float())
    dt, b_ssm, c_ssm = _ssm_inputs(p, cfg, x_conv, par)  # (B,d_in),(B,N)
    a = -torch.exp(p.A_log)
    abar = torch.exp(dt[..., None] * a)                 # (B, d_in, N)
    bx = (dt * x_conv)[..., None] * b_ssm[:, None, :]
    h = abar * cache["h"] + bx
    y = (h * c_ssm[:, None, :]).sum(-1) + x_conv * p.D_skip
    y = (y * F.silu(z[:, 0].float())).to(cd)
    out = linear(p.out_proj, y, cd)[:, None, :]
    if par is not None:
        out = par.reduce(out)
    return out, {"h": h, "conv": window[:, 1:]}
