"""Training step factory, the port's counterpart of the reference's
``runtime/train_loop.py``: on one device, or over the ranks of a
``(data, model)`` mesh -- data-parallel with a selectable gradient
reduction (the paper's technique as a knob of the trainer), FSDP over
the data axis, tensor and expert parallelism over the model axis.

``make_train_step(model, run_cfg, rules=None)`` returns ``step(state,
batch) -> (state, metrics)``: the loss and its gradients by autograd
(averaged over ``run_cfg.grad_accum`` microbatches, one backward each),
the warm-up-cosine learning rate, and the AdamW update in place.  The
metrics are the reference's ``METRIC_KEYS``: with ``grad_accum > 1`` the
reference averages the loss over the microbatches for its gradient but
reports the LAST microbatch's metrics, and so does the port.  Without
rules the reference ignores ``dp_reduce`` and reports ``wire_words`` 0;
so does the port.

With ``rules`` (``parallel.sharding.make_rules`` over a mesh from
``launch.mesh.make_host_mesh``) the model is cut to this rank's shards
by the rules' specs (``parallel.tensor_parallel.shard_model``; done by
``init_state(..., rules)`` or here, whichever comes first), one process
a rank where the reference runs one SPMD program.  Every rank takes the
global batch and keeps its data coordinate's rows (rank r of N along
the data axis takes rows ``r·b/N .. (r+1)·b/N``, the block split of
``P("data")``); the ranks of a model group run the same rows, the
model axis's collectives inside the forward (``tensor_parallel``).
The gradients are then reduced over the data group with
``run_cfg.dp_reduce``:

- ``psum`` is the reference's GSPMD step: an FSDP leaf's gradient
  comes out of its gather's backward already summed over the data
  group (a reduce-scatter) and is divided by its size; every other
  leaf's is all-reduced (``all_reduce``) to the mean;
- ``ring``, ``bidir_ring`` (``core/halfduplex``) and ``aer_topk`` (the
  event-sparse all-reduce, B5 and B6 once a reference leaf) follow the
  reference's manual region, whose state is replicated over the data
  axes: the FSDP leaves are gathered whole over the data group for the
  step, the schedule reduces each whole gradient over the data group,
  and each rank keeps its shard of the result.  ``aer_topk``
  thresholds a whole reference leaf, as the reference does, so a
  leaf split over the model axis is gathered over the model group
  first (a ``(2, 2)`` mesh reduces as ``(2, 1)`` does).

The metrics are averaged over the data group, as the reference's
``pmean``; ``wire_words`` is this rank's count of shipped events under
``aer_topk`` (the reference's replicated output is its first device's)
and 0 otherwise.  AdamW's clipping norm sums a split leaf's squares
over its shards.  The ranks holding the same shard apply the same
update to the same reduced gradient, so every shard, and every leaf no
spec splits, stays the same bit for bit on the ranks that hold it.

``aer_topk`` tiles each gradient as the reference tiles its leaves: the
reference stacks a pattern position's parameters over periods
(``stack/pos<i>/<path>``, shape ``(periods, ...)``), so its blocks of
1,024 entries run across layers wherever one layer's tensor is not a
multiple of 1,024 (norm scales, ``D_skip``).  ``ReferenceLeaves``
stacks the port's per-layer gradients into those leaves before the
reduction and hands each layer its slice after, and the AER residuals
are kept in the stacked layout, keyed ``stack.pos<i>.<path>``
(top-level leaves keep their parameter's name).

Every block kind trains on a sharded mesh (``SHARDED_KINDS``: the
dense, MoE, Mamba, hybrid and cross-attention blocks).  Sequence
parallelism (``make_rules(seq_parallel=True)``) waits for ROADMAP
A.11e and raises ``NotImplementedError``.

``make_recorded_step(model, run_cfg, group)`` is the step the dry-run
traces over an abstract mesh (``launch.dryrun``): ``group`` is the
mesh's ``RecordingGroup``, the step takes the global batch (the view of
the reference's SPMD program, which the counter divides per device), and
its reduction and ``pmean`` are recorded by the active counter, not
executed.

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
from ..models.transformer import KINDS, n_periods, pattern_for
from ..optim import adamw
from ..parallel.compat import RecordingGroup, all_reduce, axis_size
from ..parallel.sharding import NamedSharding, PartitionSpec, \
    partition_params
from ..parallel.tensor_parallel import shard_model, shard_param, \
    unshard_param

# deterministic cuBLAS, read by PyTorch at the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__all__ = ["METRIC_KEYS", "DP_MODES", "TrainState", "ReferenceLeaves",
           "init_state", "make_train_step", "make_recorded_step",
           "state_shardings"]

METRIC_KEYS = ("nll", "aux_loss", "z_loss", "drop_frac", "loss",
               "grad_norm", "lr", "wire_words")
DP_MODES = ("psum", "ring", "bidir_ring", "aer_topk")


class TrainState(NamedTuple):
    params: dict            # name -> the model's own nn.Parameter
    opt: adamw.AdamWState
    aer: dict | None        # aer_topk's residuals, by ReferenceLeaves key
    step: torch.Tensor      # 0-d int32, on the host


class ReferenceLeaves:
    """The reference's parameter leaves over the port's parameters.

    A top-level parameter is a leaf of its own, under its name.  Layer
    ``l`` of the port is the reference's period ``l // len(pattern)`` at
    position ``l % len(pattern)``, so the leaf ``stack.pos<i>.<path>``
    stacks ``stack.blocks.<p·len(pattern) + i>.<path>`` over the periods
    ``p``, in period order: shape ``(periods, *layer shape)``, the
    layout of the reference's ``stack/pos<i>/<path>``."""

    def __init__(self, model):
        pat = pattern_for(model.cfg)
        periods = n_periods(model.cfg)
        self.members: dict = {}       # key -> port names (None: not stacked)
        for name, _ in model.named_parameters():
            if not name.startswith("stack.blocks."):
                self.members[name] = None
                continue
            layer, path = name[len("stack.blocks."):].split(".", 1)
            p, i = divmod(int(layer), len(pat))
            self.members.setdefault(f"stack.pos{i}.{path}",
                                    [None] * periods)[p] = name

    def take(self, tree: dict, key: str) -> torch.Tensor:
        """Leaf ``key`` from port-named tensors, popped from ``tree`` (a
        stacked leaf is a new tensor, so its layers' tensors can go)."""
        names = self.members[key]
        if names is None:
            return tree.pop(key)
        return torch.stack([tree.pop(n) for n in names])

    def split(self, key: str, leaf: torch.Tensor) -> dict:
        """Leaf ``key`` back to port-named tensors (views)."""
        names = self.members[key]
        return {key: leaf} if names is None else dict(zip(names,
                                                          leaf.unbind(0)))

    def aer_reduce(self, grads: dict, aer: dict, group=None, *,
                   frac: float, budget: int):
        """``aer_topk`` over ``group`` on port-named gradients: ``(reduced
        port-named gradients, residuals, this rank's wire words)``.

        One reference leaf at a time, in the reference's leaf order,
        through ``aer_allreduce`` (what ``reduce_gradients`` runs a
        leaf); ``grads`` is emptied as its leaves are taken, and each new
        residual is written into ``aer``'s tensor, so at most one leaf's
        copies live at once beside the state (which is what lets
        falcon-mamba-7b's 16-layer state train on one card)."""
        if aer is None or aer.keys() != self.members.keys():
            raise ValueError("aer_topk needs the state's residuals a "
                             "ReferenceLeaves leaf (init_state makes them)")
        red, words = {}, []
        for key in sorted(self.members):
            r, new, w = sc.aer_allreduce(self.take(grads, key), aer[key],
                                         group, frac=frac, budget=budget)
            aer[key].residual.copy_(new.residual)
            del new
            red.update(self.split(key, r))
            words.append(w)
        return red, aer, torch.stack(words).sum(dtype=torch.int32)

    def zeros(self, params: dict, shapes: dict | None = None) -> dict:
        """A zero ``AerState`` a leaf, shaped and typed as the leaf
        (``shapes``: each parameter's whole shape, where ``params`` hold
        shards)."""
        def z(k, names):
            n = k if names is None else names[0]
            p = params[n]
            shape = tuple(p.shape if shapes is None else shapes[n])
            shape = shape if names is None else (len(names), *shape)
            return sc.AerState(residual=torch.zeros(
                shape, dtype=p.dtype, device=p.device))
        return {k: z(k, names) for k, names in self.members.items()}


def init_state(model, run_cfg, rules=None) -> TrainState:
    """The state of a fresh run around ``model``'s parameters (drawn by
    ``build_model`` from its seed, or loaded): gradients enabled on every
    parameter, zero moments, step 0, and for ``aer_topk`` zero residuals
    a ``ReferenceLeaves`` leaf.  The state's ``params`` ARE the model's
    parameters, which the step updates in place.  With ``rules`` the
    model is first cut to this rank's shards (``shard_model``), so the
    parameters and moments are shards; the residuals are whole leaves
    (replicated, as the reference's)."""
    if rules is not None:
        _sharded_mesh(model, run_cfg, rules)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init(params)
    par = getattr(model, "parallel", None)
    aer = ReferenceLeaves(model).zeros(
        {k: p.detach() for k, p in params.items()},
        None if par is None else {k: s.full for k, s in par.splits.items()}
    ) if run_cfg.dp_reduce == "aer_topk" else None
    return TrainState(params=params, opt=opt, aer=aer,
                      step=torch.zeros((), dtype=torch.int32))


def _split(batch: dict, n: int, parts: str = "microbatches") -> list:
    """``n`` blocks of consecutive rows."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{n} {parts}")
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


#: the block kinds a sharded mesh runs: all of the reference's
SHARDED_KINDS = KINDS


def _sharded_mesh(model, run_cfg, rules):
    """``model`` cut to this rank's shards over ``rules.mesh`` (its
    ``Parallel``), after refusing what the port does not run yet."""
    mesh = rules.mesh
    if run_cfg.dp_reduce not in DP_MODES:
        raise ValueError(f"unknown dp_reduce {run_cfg.dp_reduce!r}; one "
                         f"of {DP_MODES}")
    if rules.act_map.get("seq_sp") is not None:
        raise NotImplementedError(
            "sequence parallelism (make_rules(seq_parallel=True)) waits "
            "for ROADMAP A.11e")
    if mesh.groups is None:
        raise ValueError("the rules' mesh has no process groups (an "
                         "abstract mesh): build it with make_host_mesh")
    return shard_model(model, rules)


def _pmean(metrics: dict, group) -> dict:
    """Each metric averaged over ``group`` (one all-reduce)."""
    keys = sorted(metrics)
    t = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce(t, group)
    t = t / axis_size(group)
    return dict(zip(keys, t.unbind(0)))


def make_train_step(model, run_cfg, rules=None, *, deterministic=None):
    """Returns ``step(state, batch) -> (state, metrics)`` for ``model``.

    ``batch`` holds tensors on the model's device (``tokens`` /
    ``frames``, ``labels``, and ``mask`` / ``img_embed`` by modality):
    the global batch, whose rows each rank splits under ``rules``.
    ``metrics`` maps every ``METRIC_KEYS`` entry to a detached float32
    0-d tensor.  The state's ``params`` must be the model's parameters
    (``init_state`` and ``Checkpointer.restore`` keep them so).
    ``deterministic`` (default: on for a CUDA model) runs each step under
    PyTorch's deterministic algorithms.  ``rules`` (``parallel.sharding
    .make_rules`` over a mesh of ranks) makes it the sharded step
    reducing with ``run_cfg.dp_reduce`` (the model is cut to this rank's
    shards first, unless ``init_state`` did it); every rank of the mesh
    calls it together."""
    par = None if rules is None else _sharded_mesh(model, run_cfg, rules)
    return _make_step(model, run_cfg, par, None if par is None else par.data,
                      deterministic)


def make_recorded_step(model, run_cfg, group: RecordingGroup):
    """The data-parallel step over an abstract mesh's ``RecordingGroup``,
    as the dry-run traces it: the global batch, every parameter whole
    (the reference's SPMD program, which the counter divides per device,
    so a model axis past 1 and FSDP are counted, not executed), and the
    ``run_cfg.dp_reduce`` reduction and ``pmean`` recorded by the active
    counter.  Its collectives raise without one."""
    if not isinstance(group, RecordingGroup):
        raise TypeError(f"make_recorded_step takes a RecordingGroup, got "
                        f"{group!r}; use make_train_step to run a step")
    if run_cfg.dp_reduce not in DP_MODES:
        raise ValueError(f"unknown dp_reduce {run_cfg.dp_reduce!r}; one "
                         f"of {DP_MODES}")
    return _make_step(model, run_cfg, None, group, False)


def _shape_with(t: torch.Tensor, split, dim) -> tuple:
    """``t``'s shape with dimension ``dim`` whole (``split.full``)."""
    shape = list(t.shape)
    if dim is not None:
        shape[dim] = split.full[dim]
    return tuple(shape)


def _local(t: torch.Tensor, split, par) -> torch.Tensor:
    """This rank's shard of ``t`` along the dimensions ``t`` holds whole
    (``t`` itself where it is already this rank's)."""
    spec = PartitionSpec(*(e if t.shape[d] == split.full[d] else None
                           for d, e in enumerate(split.sharding.spec)))
    return shard_param(t, spec, par.mesh, par.rank, split.sharding.groups)


def _make_step(model, run_cfg, par, group, deterministic):
    own = dict(model.named_parameters())
    det = (next(iter(own.values())).device.type == "cuda"
           if deterministic is None else deterministic)
    mode = run_cfg.dp_reduce
    leaves = ReferenceLeaves(model) if group is not None and \
        mode == "aer_topk" else None
    split = group is not None and not isinstance(group, RecordingGroup)
    splits = {} if par is None else par.splits
    # FSDP leaves: made whole over the data group for the manual modes'
    # step, else reduced by their gather's reduce-scatter
    fsdp = [k for k, sp in splits.items() if sp.dp_dim is not None]
    manual_whole = fsdp if mode != "psum" else []
    split_over = {k: tuple(g for g, d in ((par.data, sp.dp_dim),
                                          (par.model, sp.tp_dim))
                           if d is not None)
                  for k, sp in splits.items() if sp.split}

    def reduce(grads: dict, aer):
        if mode == "psum":
            rest = {k: g for k, g in grads.items() if k not in fsdp}
            red = {k: grads[k] / par.dp for k in fsdp}
            words = torch.zeros((), dtype=torch.int32)
            if rest:
                out, _, words = sc.reduce_gradients(rest, None, group,
                                                    mode=mode)
                red.update(out)
            return red, aer, words
        if leaves is None:
            red, _, words = sc.reduce_gradients(grads, None, group,
                                                mode=mode)
        else:
            # aer_topk thresholds whole reference leaves: gather the
            # leaves split over the model axis first
            for k, sp in splits.items():
                if sp.tp_dim is not None:
                    grads[k] = unshard_param(
                        grads[k], sp.sharding,
                        _shape_with(grads[k], sp, sp.tp_dim))
            red, aer, words = leaves.aer_reduce(
                grads, aer, group, frac=run_cfg.aer_frac,
                budget=run_cfg.aer_budget)
        return ({k: _local(g, splits[k], par) if k in splits else g
                 for k, g in red.items()}, aer, words)

    def step(state: TrainState, batch: dict):
        if state.params.keys() != own.keys() or any(
                state.params[k] is not p for k, p in own.items()):
            raise ValueError("state.params must be the model's own "
                             "parameters (init_state and "
                             "Checkpointer.restore keep them so)")
        aer = state.aer
        wire = torch.zeros((), dtype=torch.float32)
        with _deterministic(det):
            for p in own.values():
                p.grad = None
            if split:                     # this rank's block of rows
                batch = _split(batch, par.dp,
                               "data-parallel ranks")[par.dp_rank]
            held = {}
            for k in manual_whole:        # the manual region's whole leaves
                p, sp = own[k], splits[k]
                held[k] = p.data
                p.data = unshard_param(p.detach(), sp.sharding,
                                       _shape_with(p, sp, sp.dp_dim))
            _, metrics = _loss_with_accum(model, batch, run_cfg.grad_accum)
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in own.items()}
            for k, p in own.items():
                p.grad = None
                if k in held:
                    p.data = held.pop(k)
            if group is not None:
                red, aer, words = reduce(grads, aer)
                grads = {k: red[k] for k in own}
                metrics = _pmean(metrics, group)
                wire = words.float()
            lr = adamw.warmup_cosine(
                state.step, base_lr=run_cfg.learning_rate,
                warmup_steps=run_cfg.warmup_steps,
                total_steps=run_cfg.total_steps)
            params, opt, gnorm = adamw.update(
                grads, state.opt, state.params, lr=lr,
                weight_decay=run_cfg.weight_decay,
                grad_clip=run_cfg.grad_clip, split_over=split_over)
            del grads
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr, wire_words=wire)
        return TrainState(params=params, opt=opt, aer=aer,
                          step=state.step + 1), metrics

    return step


def state_shardings(state, axes, rules):
    """``NamedSharding``s of a ``TrainState`` over ``rules.mesh``, given
    the model's logical axes (``LM.param_axes()``): the parameters and
    both moments follow the parameter specs; the step counters and the
    AER residuals are replicated."""
    pspec = partition_params(axes, rules)
    rep = NamedSharding(rules.mesh, PartitionSpec())
    return TrainState(
        params=pspec,
        opt=adamw.AdamWState(step=rep, mu=pspec, nu=pspec),
        aer=None if state.aer is None else {
            k: sc.AerState(residual=rep) for k in state.aer},
        step=rep)
