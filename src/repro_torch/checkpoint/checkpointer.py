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
beside the first.  Restoring onto a new mesh (``shardings``) waits for
ROADMAP A.11c.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["Checkpointer"]


def _flatten_with_paths(tree, prefix: str = ""):
    """``(path, tensor)`` of every tensor leaf: NamedTuple fields in
    order, dict keys in order, ``None`` skipped."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten_with_paths(getattr(tree, name),
                                           f"{prefix}{name}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_paths(v, f"{prefix}{k}/")
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


def _host_copy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save --
    def save(self, step: int, tree, blocking: bool = False):
        self.wait()
        leaves = list(_flatten_with_paths(tree))
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
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Write checkpoint ``step`` into ``target_tree``'s tensors (shapes
        checked, values cast to each target's dtype, on its device) and
        return the target."""
        if shardings is not None:
            raise NotImplementedError("restoring onto a new mesh "
                                      "(shardings) waits for ROADMAP A.11c")
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        with torch.no_grad():
            for key, leaf in _flatten_with_paths(target_tree):
                key = key.rstrip("/")
                arr = torch.from_numpy(arrays[key])
                if dtypes[key] == "bfloat16":
                    arr = arr.view(torch.bfloat16)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {key}: shape "
                                     f"{tuple(arr.shape)}, the target's "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(arr.to(leaf.dtype))
        return target_tree
