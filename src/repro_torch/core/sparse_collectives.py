"""Event-sparse collectives: the Address-Event Representation applied to
gradient synchronisation (paper technique, layer 1).

The PyTorch counterpart of the reference ``core/sparse_collectives.py``.
AER's economy: transmit (address, value) only for *active* entries, so
wire traffic scales with activity, not tensor size.  ``aer_allreduce`` is
the data-parallel gradient sync built on that idea:

  1. add the error-feedback residual to the local gradient;
  2. threshold-encode each (num_blocks, block) tile into fixed-budget
     event slots (B5, ``kernels/aer_encode``) — the threshold is the
     per-block ``|g|`` quantile for the target fraction;
  3. all-gather the event slots over the group (the only cross-rank
     traffic: ``budget / block`` of the dense payload);
  4. decode every peer's slots in one launch of B6
     (``kernels/aer_decode``, over (n * num_blocks, budget)) and average
     them into the dense result;
  5. keep what did not ship as the next step's residual (the FIFO
     back-pressure analogue — nothing is lost, only delayed).

Every rank of the process group calls these together.  Where the
reference takes a mesh ``axis_name`` inside ``shard_map``, these take a
``torch.distributed`` process group (``None``: the default group).
Gradient trees are nested dicts of tensors, walked in sorted-key order
(``jax.tree``'s order for dicts).  Also here: the dense baselines and the
wire-volume accounting.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..kernels import ops as K
from ..parallel.compat import axis_index, axis_size
from . import halfduplex as hd

__all__ = ["AerState", "aer_allreduce", "dense_allreduce",
           "reduce_gradients", "init_aer_states", "dense_allreduce_bytes",
           "aer_allreduce_bytes", "tree_leaves", "tree_map"]


class AerState(NamedTuple):
    """Per-tensor error-feedback residual (same shape as the gradient)."""
    residual: torch.Tensor

    @classmethod
    def init(cls, x: torch.Tensor) -> "AerState":
        return cls(residual=torch.zeros_like(x))


def aer_allreduce(x: torch.Tensor, state: AerState, group=None, *,
                  frac: float = 0.02, budget: int = K.DEFAULT_BUDGET,
                  block: int = K.DEFAULT_BLOCK):
    """Event-sparse all-*mean* of ``x`` over ``group``.

    Returns ``(dense mean-reduced tensor — identical on every rank, new
    AerState, wire words sent (0-d int32 tensor))``.
    """
    n = axis_size(group)
    y = x + state.residual
    tiles, size = K.pad_to_blocks(y, block)
    tau = K.tau_from_fraction(tiles, frac)
    ev = K.aer_compress(tiles, tau, budget)

    # the wire: fixed-width event slots, all-gathered over the group
    nb = tiles.shape[0]
    all_idx = ev.idx.new_empty((n, nb, budget))
    all_val = ev.val.new_empty((n, nb, budget))
    dist.all_gather(list(all_idx.unbind(0)), ev.idx, group=group)
    dist.all_gather(list(all_val.unbind(0)), ev.val, group=group)

    dec_all = K.aer_decompress(
        K.EventBlocks(all_idx.reshape(n * nb, budget),
                      all_val.reshape(n * nb, budget), ev.count, ev.wanted),
        block).reshape(n, nb, block)
    summed = dec_all.sum(0).div_(n)

    own_dec = dec_all[axis_index(group)]
    new_residual = K.unpad_from_blocks(tiles - own_dec, size, x.shape)
    reduced = K.unpad_from_blocks(summed, size, x.shape)
    wire_words = ev.count.sum(dtype=torch.int32)
    return reduced, AerState(residual=new_residual), wire_words


def dense_allreduce(x: torch.Tensor, group=None, *,
                    schedule: str = "psum") -> torch.Tensor:
    """Dense mean baselines: ``psum`` (``dist.all_reduce``) | ``ring`` |
    ``bidir_ring``."""
    n = axis_size(group)
    if schedule == "psum":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n
    if schedule not in ("ring", "bidir_ring"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return hd.ring_allreduce(
        x, group, bidirectional=(schedule == "bidir_ring")) / n


# --- gradient trees: nested dicts, leaves in sorted-key order -----------

def tree_leaves(tree) -> list:
    """Leaves of a nested dict (or a single leaf) in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or sorted(r) != sorted(tree)
               for r in rest):
            raise ValueError("trees differ in structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def reduce_gradients(grads, aer_states, group=None, *, mode: str = "psum",
                     frac: float = 0.02, budget: int = K.DEFAULT_BUDGET):
    """Tree-wise data-parallel gradient reduction with a selectable
    schedule.

    ``mode``: ``psum`` | ``ring`` | ``bidir_ring`` | ``aer_topk``.
    Returns ``(grads, new_aer_states, wire_words_total)``; the dense modes
    hand the states back as they came and count 0 words.  Under
    ``aer_topk`` each leaf takes one B5 and one B6 launch on the card.
    """
    if mode in ("psum", "ring", "bidir_ring"):
        out = tree_map(lambda g: dense_allreduce(g, group, schedule=mode),
                       grads)
        dev = tree_leaves(grads)[0].device
        return out, aer_states, torch.zeros((), dtype=torch.int32,
                                            device=dev)
    if mode != "aer_topk":
        raise ValueError(f"unknown mode {mode!r}")
    words = []

    def one(g, st):
        r, ns, w = aer_allreduce(g, st, group, frac=frac, budget=budget)
        words.append(w)
        return r, ns

    pairs = tree_map(one, grads, aer_states)
    reduced = tree_map(lambda p: p[0], pairs)
    states = tree_map(lambda p: p[1], pairs)
    return reduced, states, torch.stack(words).sum(dtype=torch.int32)


def init_aer_states(grads_or_params):
    return tree_map(AerState.init, grads_or_params)


# --- wire-volume accounting (the paper's "I/O saved" in bytes) ----------

def dense_allreduce_bytes(n_params: int, n_devices: int, bytes_per=4,
                          bidirectional=False) -> float:
    return hd.wire_bytes_per_direction(n_params * bytes_per, n_devices,
                                       bidirectional)


def aer_allreduce_bytes(n_params: int, n_devices: int, frac: float,
                        budget: int = K.DEFAULT_BUDGET,
                        block: int = K.DEFAULT_BLOCK) -> float:
    """All-gather of event slots: each device ships nb*budget words once
    around the ring ((n-1)/n of it per link direction)."""
    nb = -(-n_params // block)
    shipped = min(budget, int(frac * block) + 1) * nb * 4
    return (n_devices - 1) / n_devices * shipped * n_devices / n_devices
