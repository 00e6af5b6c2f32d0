"""Atomic, asynchronous checkpointing, the port's copy of the reference's
``checkpoint/checkpointer.py`` and of its on-disk protocol.

Layout: ``<dir>/step_<k:08d>/arrays.npz`` + ``manifest.json``, written
to a temporary directory, the manifest fsync'd, then renamed, so a crash
mid-write never leaves a listed checkpoint without its manifest, as in
the reference; ``keep`` checkpoints stay.  Saves
run on a background thread (training continues); ``wait()`` joins
before the next save or a restore.  Leaves are named by their path in
the state, ``/``-joined: NamedTuple fields and dict keys, e.g.
``params/stack.blocks.0.mamba.A_log`` or ``opt/mu/head.w``; ``None``
leaves (no AER residuals) are skipped.  bfloat16 leaves are stored as
their int16 bits, the manifest naming the dtype.

``save`` copies every leaf to host memory before it returns, as the
reference's ``np.asarray`` does: the optimiser updates the state's
tensors in place, and a copy taken later, inside the thread, would catch
them mid-update.  ``restore(step, target)`` checks each leaf's shape,
casts it to the target leaf's dtype and writes it INTO the target's
tensor, on its device, returning the target: the state's parameters are
the model's, and a second copy of a card-sized state would not fit
beside the first.

Under data parallelism (``group``: the mesh's data-parallel process
group, whose ranks hold the same replicated state) every rank calls
``save``, ``wait``, ``latest_step`` and ``restore`` together, at the
same points.  Rank 0 of the group alone writes; ``wait`` joins its
writer and then holds every rank at a barrier, so a manifest is read
only after it is written; ``latest_step`` is rank 0's answer, broadcast,
so every rank restores the same checkpoint.  ``restore(step, target,
shardings=)`` takes ``runtime.train_loop.state_shardings``' tree on the
(possibly new, possibly smaller) mesh: a replicated leaf is loaded
whole on every rank, and a leaf a spec splits is cut to this rank's
shard (``parallel.tensor_parallel.shard_param``), as the reference
writes its shards through ``jax.device_put``
(``src/repro/checkpoint/checkpointer.py:104-124``).

A sharded state (over a model axis or FSDP) is saved in the reference's
layout, whole leaves: ``save(step, tree, shardings=)`` gathers each
split leaf over its groups (every rank of the mesh calls it, so
``group`` is then the mesh's whole world) and rank 0 writes them.  So a
checkpoint of a ``(2, 2)`` FSDP run restores on a world of one, and
back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.compat import barrier, global_rank, group_device
from ..parallel.tensor_parallel import (SPLIT_ATTR, shard_param,
                                        unshard_param, whole_shape)

__all__ = ["Checkpointer"]


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _is_sharding(x) -> bool:
    return hasattr(x, "spec") and hasattr(x, "shards")


def _flatten_with_paths(tree, prefix: str = "", leaf=_is_tensor):
    """``(path, leaf)`` of every leaf (a tensor, or what ``leaf``
    says): NamedTuple fields in order, dict keys in order, ``None``
    skipped."""
    if tree is None:
        return
    if leaf(tree):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten_with_paths(getattr(tree, name),
                                           f"{prefix}{name}/", leaf)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_paths(v, f"{prefix}{k}/", leaf)
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a "
                        f"{type(tree).__name__}, not a tensor")


def _structure(tree) -> str:
    """The state's structure, for the manifest."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{n}={_structure(getattr(tree, n))}"
            for n in tree._fields) + ")"
    return "{" + ", ".join(f"{k!r}: {_structure(v)}"
                           for k, v in tree.items()) + "}"


def _whole(t: torch.Tensor, sharding) -> torch.Tensor:
    """A leaf whole: gathered over its groups where its spec splits it
    (every rank of the mesh calls this together)."""
    if sharding.shards == 1:
        return t
    return unshard_param(t.detach(), sharding,
                         whole_shape(t.shape, sharding))


def _host_copy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, *, group=None):
        self.dir = directory
        self.keep = keep
        self.group = group
        self._thread: threading.Thread | None = None
        if self._writer:
            os.makedirs(directory, exist_ok=True)
        if group is not None:
            barrier(group)

    @property
    def _writer(self) -> bool:
        return self.group is None or dist.get_rank(self.group) == 0

    # ------------------------------------------------------------ save --
    def save(self, step: int, tree, blocking: bool = False,
             shardings=None):
        """Write ``tree`` as checkpoint ``step`` (on a thread unless
        ``blocking``).  ``shardings`` (``state_shardings``' tree): the
        leaves a spec splits are this rank's shards, gathered whole
        first; a tree holding a sharded model's split parameters needs
        it."""
        self.wait()
        leaves = list(_flatten_with_paths(tree))
        if shardings is not None:
            specs = dict(_flatten_with_paths(shardings, leaf=_is_sharding))
            leaves = [(k, _whole(t, specs[k])) for k, t in leaves]
        elif any(getattr(t, SPLIT_ATTR, None) is not None and
                 tuple(t.shape) != getattr(t, SPLIT_ATTR).full
                 for _, t in leaves):
            raise ValueError("the tree holds shards of a sharded model; "
                             "pass shardings=state_shardings(...) so that "
                             "save writes whole leaves")
        if not self._writer:
            if blocking:
                barrier(self.group)
            return
        arrays = {k.rstrip("/"): _host_copy(t) for k, t in leaves}
        dtypes = {k.rstrip("/"): str(t.dtype).removeprefix("torch.")
                  for k, t in leaves}
        structure = _structure(tree)

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {
                "step": step,
                "time": time.time(),
                "treedef": structure,
                "keys": sorted(arrays),
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "dtypes": dtypes,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
            if self.group is not None:
                barrier(self.group)
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            barrier(self.group)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps() if self._writer else []
        last = steps[-1] if steps else -1
        if self.group is not None:
            t = torch.tensor([last], dtype=torch.int64,  # torchlint: disable=TL002 (once a restore)
                             device=group_device(self.group))
            dist.broadcast(t, global_rank(self.group, 0), group=self.group)
            last = int(t)
        return None if last < 0 else last

    def restore(self, step: int, target_tree, shardings=None):
        """Write checkpoint ``step`` into ``target_tree``'s tensors (shapes
        checked, values cast to each target's dtype, on its device) and
        return the target.  ``shardings``: a tree of ``NamedSharding``
        parallel to the target (``state_shardings`` on the new mesh); a
        leaf it splits is cut to this process's shard (its global rank;
        rank 0 outside a process group)."""
        specs = {}
        if shardings is not None:
            specs = dict(_flatten_with_paths(shardings, leaf=_is_sharding))
            for key, _ in _flatten_with_paths(target_tree):
                if key not in specs:
                    raise ValueError(f"no sharding for checkpoint leaf "
                                     f"{key.rstrip('/')}")
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        with torch.no_grad():
            for path, leaf in _flatten_with_paths(target_tree):
                key = path.rstrip("/")
                arr = torch.from_numpy(arrays[key])
                if dtypes[key] == "bfloat16":
                    arr = arr.view(torch.bfloat16)
                sh = specs.get(path)
                if sh is not None and sh.shards > 1:
                    arr = shard_param(arr, sh.spec, sh.mesh, rank,
                                      sh.groups)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {key}: shape "
                                     f"{tuple(arr.shape)}, the target's "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(arr.to(leaf.dtype))
        return target_tree
