"""AdamW with global-norm clipping and float32 moments, the port's copy
of the reference's ``optim/adamw.py``.

Trees are dicts of tensors keyed by parameter name (the trainer's
``TrainState.params``: the model's own parameters).  ``update`` follows
the reference's formula op for op:

    g = clip(g) ; m = b1·m + (1-b1)·g ; v = b2·v + (1-b2)·g·g
    p = p - lr·(m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd·p)

applied to every parameter (decay included), each product and sum a
tensor op of its own so that nothing is fused into an FMA.  It works IN
PLACE: the gradients are scaled, the moments and the parameters
overwritten, and the returned trees are the same tensors (a second copy
of a 2-billion-parameter state does not fit one card beside the first).
``torch.optim.AdamW`` is not this update: it decays the parameter before
the Adam step and rounds its bias corrections differently.

The step counter, the learning rate and the bias corrections are 0-d
float32 tensors on the host, so a step needs no device sync for them.
On the CPU every op is the reference's and rounds as it does, except the
float32 ``pow`` of the bias corrections and ``cos`` of the schedule,
which XLA and PyTorch may round an ulp apart.  On the card PyTorch
divides by a host scalar as a product with its reciprocal, which may
round an ulp from the division; the result is still the same bits on
every run.

On a mesh each rank holds its shard of a split leaf: ``global_norm``
(and ``update``) take ``split_over``, each such leaf's process groups,
and sum the leaf's squares over them, counting a leaf that no spec
splits once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.compat import all_reduce

__all__ = ["AdamWState", "init", "global_norm", "clip_by_global_norm",
           "update", "warmup_cosine"]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the host
    mu: dict
    nu: dict


def init(params: dict) -> AdamWState:
    """Zero float32 moments shaped as each parameter, on its device."""
    def zeros(t):
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in t.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=zeros(params), nu=zeros(params))


def global_norm(tree: dict, split_over=None) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in float32, the leaves in the tree's
    order.  ``split_over`` maps the name of a leaf held in shards to the
    process groups its shards span: the squares of the leaves that
    span the same groups are summed, then over those groups (every
    rank of them calls this together), and the sums added in the order
    of their first leaves."""
    if not split_over:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree.values()))
    sums, groups = {}, {}
    for k, x in tree.items():
        gs = tuple(split_over.get(k, ()))
        key = tuple(map(id, gs))
        groups[key] = gs
        sq = torch.sum(torch.square(x.float()))
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for key, s in sums.items():
        for g in groups[key]:
            all_reduce(s, g)
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(grads · min(1, max_norm / max(norm, 1e-9)), norm)``: the
    scaled gradients are new tensors."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def update(grads: dict, state: AdamWState, params: dict, *, lr, b1=0.9,
           b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
           split_over=None):
    """One AdamW step, in place.  Returns ``(params, new_state,
    grad_norm)``; ``params``, the moments and (when clipping) the
    gradients are the tensors passed in, overwritten.  ``lr`` is a float
    or a 0-d tensor; ``split_over`` as ``global_norm`` takes it."""
    with torch.no_grad():
        gnorm = global_norm(grads, split_over)
        if grad_clip and grad_clip > 0:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for g in grads.values():
                g.mul_(scale.to(g.device))
        step = state.step + 1
        stepf = step.float()
        b1c = 1.0 - b1 ** stepf
        b2c = 1.0 - b2 ** stepf
        for k, p in params.items():
            gf = grads[k].float()
            m, v = state.mu[k], state.nu[k]
            m.mul_(b1).add_(gf.mul(1 - b1))
            v.mul_(b2).add_(gf.mul(1 - b2).mul_(gf))
            mhat = m.div(b1c)
            denom = v.div(b2c).sqrt_().add_(eps)
            delta = mhat.div_(denom).add_(p.float().mul(weight_decay))
            delta.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.float().sub_(delta))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then a cosine down to ``final_frac
    · base_lr`` at ``total_steps``; a 0-d float32 tensor on the host,
    computed in float32 in the reference's order."""
    step = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) /
                    max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
