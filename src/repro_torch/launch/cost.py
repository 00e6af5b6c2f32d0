"""A FLOP / byte / collective / memory counter over PyTorch's dispatcher:
the port's counterpart of the reference's ``launch/hlo_cost.py``.

The reference reads its three roofline inputs from post-optimisation
HLO text.  The port has no compiler between the model and the device,
so it counts the aten operators a step really dispatches: a
``TorchDispatchMode`` sees every operator below autograd (forward,
backward and the recompute of checkpointed regions alike), on CUDA
where the step runs and on ``meta`` where nothing runs, and the counts
are the same on both.  Eager tracing unrolls every loop, so no trip
count is ever unknown.  The conventions are the reference's:

  flops            2·M·N·K for every product (``mm``, ``bmm``,
                   ``addmm``, ``baddbmm``, ``mv``, ``dot``; ``matmul``
                   and ``einsum`` reach the dispatcher as these) and for
                   convolutions; elementwise work is not counted;
  bytes_accessed   the operands plus the result of every operator at its
                   boundary; a view moves nothing and an allocation
                   (``empty``) writes nothing; an operand that aliases
                   its result (in-place ops, ``out=``) is charged as
                   ``hlo_cost`` charges an aliased operand: the other
                   operands, plus the result up to their size;
  collectives      per kind, the result bytes and a ``<kind>_count``,
                   recorded by the port's collectives themselves
                   (``record_collective``), on a real process group or
                   on the recording stand-in of an abstract mesh; and
                   the same bytes and counts by the mesh axis the
                   group spans, with the group's global ranks
                   (``collectives_by_axis``: what the roofline prices
                   by where the ranks lie); what a collective runs to
                   move its tensors is not counted (``uncounted``);
  peak_live_bytes  the peak, over the traced step, of the bytes of the
                   storages it created that are still alive.

The port's kernels are ctypes launches the dispatcher cannot see.  Each
kernel's wrapper in ``kernels.ops`` (and ``SelectiveScanFn``) runs its
kernel, its plain version or its ``meta`` route inside ``kernel(name)``,
which hides the operators inside from the counter and records the
kernel's operand and result bytes instead: bytes and no flops, as the
reference counts a custom call.

A counter built without ``axis_sizes`` counts what it sees whole: one
rank's own program (the dry-run traces rank 0's sharded step), or one
device's.  Per device of a global program: a counter built with
``axis_sizes`` (a mesh's ``{axis: size}``) divides each operator's
flops, bytes, new storage and collective bytes by the product of the
sizes of the mesh axes its result is sharded over.  A
tensor's axes are a tag: parameters and inputs are tagged by the caller
(``tag``), ``parallel.sharding.shard_activation`` sets the tag of an
activation to the axes its logical names resolve to, and every other
result takes the union of its operands' tags; an untagged result counts
whole on every device, as a replicated computation does.

The active counter is process-wide, not per thread, because autograd
runs a CUDA backward on a thread of its own and the kernel wrappers
must find the counter there too.
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from collections import Counter as _Tally

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["Counter", "analyze", "active", "kernel", "record_collective",
           "tag", "uncounted", "COST_KEYS", "COLLECTIVES"]

#: the keys of ``Counter.result()``, as the reference's
#: ``hlo_cost.analyze`` names them
COST_KEYS = ("flops", "bytes_accessed", "collectives",
             "collective_bytes_total", "unknown_trip_count_loops")
#: the collective kinds, as HLO names them
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.mv,
            _aten.dot, _aten.addmv}
_CONVS = {_aten.convolution, _aten.convolution_backward}
#: allocations: their result is not written
_ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
           _aten.new_empty, _aten.new_empty_strided}

_ACTIVE: list = []
_LOCK = threading.Lock()


def active() -> "Counter | None":
    """The innermost counting counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an operator's arguments or results: tensors,
    lists and tuples of them, dicts of keyword arguments."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _matmul_flops(func, args, out) -> float:
    """2 x (result elements) x (contracted length)."""
    p = func._overloadpacket
    if p in (_aten.addmm, _aten.baddbmm, _aten.addmv):
        args = args[1:]
    a = args[0]
    k = a.shape[-1] if a.dim() else 1
    return 2.0 * max(out.numel(), 1) * k


def _conv_flops(func, args, out) -> float:
    """2 x output elements x (kernel elements / output channels), the
    reference's convolution rule; the backward counts its input and
    weight gradients as one product each."""
    if func._overloadpacket is _aten.convolution:
        w = args[1]
        return 2.0 * out.numel() * w.numel() / max(w.shape[0], 1)
    grad_out, _, w = args[0], args[1], args[2]
    per = 2.0 * grad_out.numel() * w.numel() / max(w.shape[0], 1)
    mask = args[-1]
    return per * (int(mask[0]) + int(mask[1]))


class Counter(TorchDispatchMode):
    """Counts what the operators dispatched inside ``with Counter():``
    do; ``result()`` has the reference's keys.  ``axis_sizes`` (a mesh's
    shape) turns on per-device division by tags."""

    def __init__(self, axis_sizes: dict | None = None):
        super().__init__()
        self.axis_sizes = dict(axis_sizes or {})
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict = {}
        self.by_axis: dict = {}
        self.ops = _Tally()
        self.kernels: dict = {}
        self.live = 0.0
        self.peak_live = 0.0
        self._storages: dict = {}
        self._tags = WeakIdKeyDictionary() if self.axis_sizes else None

    # -- tags -----------------------------------------------------------

    def tag(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Set ``t``'s mesh axes (a set of axis names; ``()``: none)."""
        if self._tags is not None:
            self._tags[t] = frozenset(a for a in axes if a is not None)
        return t

    def axes_of(self, tensors) -> frozenset:
        if self._tags is None:
            return frozenset()
        out = frozenset()
        for t in tensors:
            out |= self._tags.get(t, frozenset())
        return out

    def divisor(self, axes) -> int:
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    # -- storages -------------------------------------------------------

    def _track(self, tensors, div: int) -> None:
        """Count each result's storage as live (once) until it dies."""
        for t in tensors:
            if t.layout is not torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            size = st.nbytes() / div
            self._storages[key] = size
            with _LOCK:
                self.live += size
                self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        size = self._storages.pop(key, 0.0)
        with _LOCK:
            self.live -= size

    # -- the dispatcher -------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # under inference mode composite operators (matmul, einsum,
            # linear) arrive whole: count what they decompose into, as
            # with autograd on
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.ops[str(func._overloadpacket)] += 1
        axes = self.axes_of(ins)
        div = self.divisor(axes)
        if self._tags is not None:
            for t in outs:
                self._tags[t] = axes
        p = func._overloadpacket
        if p in _MATMULS and outs:
            self.flops += _matmul_flops(func, args, outs[0]) / div
        elif p in _CONVS and outs:
            self.flops += _conv_flops(func, args, outs[0]) / div
        self.bytes += self._op_bytes(func, p, ins, outs) / div
        if not self._is_view(func):
            self._track([t for t in outs if all(t is not i for i in ins)],
                        div)
        return out

    @staticmethod
    def _is_view(func) -> bool:
        r = func._schema.returns
        return bool(r) and r[0].alias_info is not None and \
            not r[0].alias_info.is_write

    def _op_bytes(self, func, p, ins, outs) -> float:
        if self._is_view(func):
            return 0.0
        if p in _ALLOCS:
            return 0.0
        written = [r.alias_info is not None and r.alias_info.is_write
                   for r in func._schema.returns]
        if any(written):
            # in place or out=: the aliased operand is not read again; the
            # result is charged up to the other operands' size (hlo_cost)
            aliased = {id(t) for t in outs}
            other = sum(_nbytes(t) for t in ins if id(t) not in aliased)
            return other + min(sum(_nbytes(t) for t in outs), other)
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    # -- kernels and collectives ----------------------------------------

    def record_kernel(self, name: str, operands, results,
                      nbytes: int | None = None) -> None:
        """One launch of the kernel ``name`` (or of its plain version, or
        its meta route) on ``operands`` giving ``results``: ``nbytes``
        (default: their bytes), no flops; the results take the operands'
        tags."""
        ins, outs = _tensors(operands), _tensors(results)
        axes = self.axes_of(ins)
        div = self.divisor(axes)
        if self._tags is not None:
            for t in outs:
                self._tags[t] = axes
        if nbytes is None:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        nbytes /= div
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0})
        k["launches"] += 1
        k["bytes"] += nbytes
        self.ops[f"kernel.{name}"] += 1
        self._track(outs, div)

    def record_collective(self, kind: str, result: torch.Tensor, *,
                          axis: str | None = None,
                          ranks=None) -> None:
        """One collective of ``kind`` whose result on this device is
        ``result`` (whole on a counter with no mesh, divided by its tag
        on one with), over a group spanning the mesh axis ``axis`` (None:
        not said) whose global ranks are ``ranks``."""
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}; one of "
                             f"{COLLECTIVES}")
        nbytes = _nbytes(result) / self.divisor(self.axes_of([result]))
        self.coll[kind] = self.coll.get(kind, 0) + nbytes
        self.coll[kind + "_count"] = self.coll.get(kind + "_count", 0) + 1
        a = self.by_axis.setdefault(str(axis), {
            "bytes": 0, "count": 0,
            "ranks": None if ranks is None else list(ranks)})
        a["bytes"] += nbytes
        a["count"] += 1

    # -- entering and the result ----------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def result(self) -> dict:
        """The reference's keys, plus the counter's own: the peak of live
        bytes, the operator tally and the kernels' launches and bytes."""
        total = sum(v for k, v in self.coll.items()
                    if not k.endswith("_count"))
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "collectives": dict(self.coll),
                "collective_bytes_total": total,
                "collectives_by_axis": {k: dict(v) for k, v in
                                        sorted(self.by_axis.items())},
                "unknown_trip_count_loops": 0,
                "peak_live_bytes": self.peak_live,
                "op_counts": dict(sorted(self.ops.items())),
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())}}


def analyze(fn, *args, axis_sizes=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a fresh ``Counter`` and return
    its ``result()`` with ``"value"``, what ``fn`` returned."""
    with Counter(axis_sizes) as c:
        value = fn(*args, **kwargs)
    out = c.result()
    out["value"] = value
    return out


class _KernelRegion:
    """What ``kernel`` yields: ``record(operands, results)`` reports the
    launch to the counter that was active on entry (if any)."""

    __slots__ = ("counter", "name")

    def __init__(self, counter, name):
        self.counter, self.name = counter, name

    def record(self, operands, results, nbytes: int | None = None):
        if self.counter is not None:
            self.counter.record_kernel(self.name, operands, results, nbytes)
        return results


@contextlib.contextmanager
def kernel(name: str):
    """The region of one kernel launch: inside it no operator is counted
    (the wrapper's allocations, the plain version's operators), and the
    region's ``record`` counts the kernel's bytes instead.  Without an
    active counter it only yields."""
    c = active()
    if c is None:
        yield _KernelRegion(None, name)
        return
    with _disable_current_modes():
        yield _KernelRegion(c, name)


def record_collective(kind: str, result: torch.Tensor, *,
                      axis: str | None = None, ranks=None) -> None:
    """Report a collective to the active counter (none: nothing)."""
    c = active()
    if c is not None:
        c.record_collective(kind, result, axis=axis, ranks=ranks)


@contextlib.contextmanager
def uncounted():
    """A region whose operators no counter sees: what a collective runs
    to move its tensors (its result is recorded by
    ``record_collective`` instead)."""
    if active() is None:
        yield
        return
    with _disable_current_modes():
        yield


def tag(t: torch.Tensor, axes) -> torch.Tensor:
    """Tag ``t`` with mesh axes for the active counter (none: nothing)."""
    c = active()
    if c is not None:
        c.tag(t, axes)
    return t
