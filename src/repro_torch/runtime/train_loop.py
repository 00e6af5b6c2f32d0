"""Training step factory on one device, the port's counterpart of the
reference's ``runtime/train_loop.py``.

``make_train_step(model, run_cfg)`` returns ``step(state, batch) ->
(state, metrics)``: the loss and its gradients by autograd (averaged
over ``run_cfg.grad_accum`` microbatches, one backward each), the
warm-up-cosine learning rate, and the AdamW update in place.  The
metrics are the reference's ``METRIC_KEYS``: with ``grad_accum > 1`` the
reference averages the loss over the microbatches for its gradient but
reports the LAST microbatch's metrics, and so does the port.

With one device and no sharding rules the reference ignores
``dp_reduce`` and reports ``wire_words`` 0; so does the port.  Manual
data parallelism over several cards (``rules``, ``state_shardings``,
the ``ring`` / ``bidir_ring`` / ``aer_topk`` reductions) waits for
ROADMAP A.11c and raises ``NotImplementedError``.

Determinism: a run restarted from a checkpoint must end bit-identical
to an uninterrupted one.  On the card the step runs under
``torch.use_deterministic_algorithms(True)``, because the backward of
the embedding gather and of the MoE dispatch otherwise adds with float
atomics in no fixed order; that mode needs ``CUBLAS_WORKSPACE_CONFIG``
set (``:4096:8``) before the process's first matrix product, which this
module does when it is imported and the variable is unset (a product
run before that makes the first deterministic step raise, with
PyTorch's message naming the variable).  PyTorch's filling of fresh tensors with NaN in
that mode is turned off (``torch.utils.deterministic
.fill_uninitialized_memory``): every tensor the step reads is written
first.  The previous settings come back after each step.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch

from ..core import sparse_collectives as sc
from ..optim import adamw

# deterministic cuBLAS, read by PyTorch at the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__all__ = ["METRIC_KEYS", "TrainState", "init_state", "make_train_step",
           "state_shardings"]

METRIC_KEYS = ("nll", "aux_loss", "z_loss", "drop_frac", "loss",
               "grad_norm", "lr", "wire_words")


class TrainState(NamedTuple):
    params: dict            # name -> the model's own nn.Parameter
    opt: adamw.AdamWState
    aer: dict | None        # error-feedback residuals (aer_topk only)
    step: torch.Tensor      # 0-d int32, on the host


def init_state(model, run_cfg) -> TrainState:
    """The state of a fresh run around ``model``'s parameters (drawn by
    ``build_model`` from its seed, or loaded): gradients enabled on every
    parameter, zero moments, step 0.  The state's ``params`` ARE the
    model's parameters, which the step updates in place."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init(params)
    aer = {k: sc.AerState.init(p.detach()) for k, p in params.items()} \
        if run_cfg.dp_reduce == "aer_topk" else None
    return TrainState(params=params, opt=opt, aer=aer,
                      step=torch.zeros((), dtype=torch.int32))


def _split(batch: dict, n: int) -> list:
    """``n`` microbatches of consecutive rows."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{n} microbatches")
    m = rows // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _loss_with_accum(model, batch: dict, n_accum: int):
    """Mean loss over ``n_accum`` microbatches, the gradient of that
    mean accumulated into each parameter's ``.grad`` (one backward per
    microbatch, each seeded with 1/n_accum), and the last microbatch's
    metrics.  Returns ``(mean loss, metrics)``, detached."""
    if n_accum <= 1:
        loss, metrics = model.loss(batch)
        loss.backward()
        return loss.detach(), metrics
    total = 0.0
    for mb in _split(batch, n_accum):
        loss, metrics = model.loss(mb)
        (loss / n_accum).backward()
        total = total + loss.detach()
    return total / n_accum, metrics


@contextlib.contextmanager
def _deterministic(on: bool):
    if not on:
        yield
        return
    import torch.utils.deterministic as tud
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        tud.fill_uninitialized_memory = prev[2]


def make_train_step(model, run_cfg, rules=None, *, deterministic=None):
    """Returns ``step(state, batch) -> (state, metrics)`` for ``model``.

    ``batch`` holds tensors on the model's device (``tokens`` /
    ``frames``, ``labels``, and ``mask`` / ``img_embed`` by modality);
    ``metrics`` maps every ``METRIC_KEYS`` entry to a detached float32
    0-d tensor.  The state's ``params`` must be the model's parameters
    (``init_state`` and ``Checkpointer.restore`` keep them so).
    ``deterministic`` (default: on for a CUDA model) runs each step under
    PyTorch's deterministic algorithms.  ``rules`` (a mesh's sharding)
    waits for ROADMAP A.11c."""
    if rules is not None:
        raise NotImplementedError(
            "make_train_step with sharding rules (manual data parallelism "
            "over several cards) waits for ROADMAP A.11c; one device takes "
            "rules=None")
    own = dict(model.named_parameters())
    det = (next(iter(own.values())).device.type == "cuda"
           if deterministic is None else deterministic)

    def step(state: TrainState, batch: dict):
        if state.params.keys() != own.keys() or any(
                state.params[k] is not p for k, p in own.items()):
            raise ValueError("state.params must be the model's own "
                             "parameters (init_state and "
                             "Checkpointer.restore keep them so)")
        with _deterministic(det):
            for p in own.values():
                p.grad = None
            _, metrics = _loss_with_accum(model, batch, run_cfg.grad_accum)
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in own.items()}
            lr = adamw.warmup_cosine(
                state.step, base_lr=run_cfg.learning_rate,
                warmup_steps=run_cfg.warmup_steps,
                total_steps=run_cfg.total_steps)
            params, opt, gnorm = adamw.update(
                grads, state.opt, state.params, lr=lr,
                weight_decay=run_cfg.weight_decay,
                grad_clip=run_cfg.grad_clip)
            for p in own.values():
                p.grad = None
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr,
                       wire_words=torch.zeros((), dtype=torch.float32))
        return TrainState(params=params, opt=opt, aer=state.aer,
                          step=state.step + 1), metrics

    return step


def state_shardings(state, axes, rules):
    """Shardings of a ``TrainState`` over a mesh: ROADMAP A.11c."""
    raise NotImplementedError("state_shardings (a sharded train state "
                              "over a mesh) waits for ROADMAP A.11c")
