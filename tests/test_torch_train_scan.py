"""The selective scan's gradient on ``device="cpu"``: ``ref.selective_scan_bwd``
(the plain version of the backward kernel) and the CPU branch of
``SelectiveScanFn`` (what ``ops.selective_scan`` differentiates through)
against ``jax.vjp`` of the reference's chunked scan
(``repro.models.mamba.selective_scan``, the scan its Mamba gradient comes
from) and of its step oracle ``ref.selective_scan_ref``, and against
``torch.autograd`` through the port's plain forward.

Inputs are ``_torch_cases.scan_cases()`` (underflowing ``exp(dt·A)``,
N = 1..32, widths off the kernel's tile edges), with ``dh_final`` zero
and random.  Tolerance: each gradient within ``1e-5 · max|want| + 1e-30``
of the reference's (float32 sums in another order; measured at most
~5e-7 of the max on these cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba as jm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as ssk

from _torch_cases import (SCAN_BWD_TOL, scan_arrays, scan_cotangents,
                          scan_specs)

SPECS = scan_specs()
IDS = [s[0] for s in SPECS]
NAMES = ("dx", "ddt", "db", "dc", "da")
TOL = SCAN_BWD_TOL
_VJP = {}


def _reference_vjp(spec, which: str):
    """The reference's pullback at the spec's inputs, made once."""
    key = (spec[0], which)
    if key not in _VJP:
        fn = (jref.selective_scan_ref if which == "oracle" else
              (lambda *a: jm.selective_scan(*a, chunk=16)))
        _, _VJP[key] = jax.vjp(fn, *map(jnp.asarray, scan_arrays(spec)))
    return _VJP[key]


def _held(want, got, label):
    for name, w, g in zip(NAMES, want, got, strict=True):
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape, (label, name)
        err = np.abs(g - w).max(initial=0.0)
        assert err <= TOL * np.abs(w).max(initial=0.0) + 1e-30, \
            (label, name, err, np.abs(w).max(initial=0.0))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("which", ["chunked", "oracle"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_plain_backward_matches_reference_vjp(spec, which, dh):
    dy, dhf = scan_cotangents(spec, dh)
    want = _reference_vjp(spec, which)((jnp.asarray(dy), jnp.asarray(dhf)))
    got = tref.selective_scan_bwd(*map(_t, scan_arrays(spec)), _t(dy),
                                  _t(dhf) if dh else None)
    _held(want, [v.numpy() for v in got], f"{spec[0]} vs {which}")


@pytest.mark.parametrize("dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_autograd_function_matches_vjp_and_plain_autograd(spec, dh):
    """``ops.selective_scan`` (``SelectiveScanFn`` on the CPU) routes each
    cotangent to its operand: against the reference's chunked pullback
    and against autograd through the plain forward loop."""
    dy, dhf = scan_cotangents(spec, dh)
    ins = [_t(v).requires_grad_() for v in scan_arrays(spec)]
    y, h = ops.selective_scan(*ins)
    outs, cots = ((y, h), (_t(dy), _t(dhf))) if dh else ((y,), (_t(dy),))
    got = torch.autograd.grad(outs, ins, cots)
    want = _reference_vjp(spec, "chunked")((jnp.asarray(dy),
                                            jnp.asarray(dhf)))
    _held(want, [g.numpy() for g in got], f"{spec[0]} Function vs vjp")
    ins2 = [_t(v).requires_grad_() for v in scan_arrays(spec)]
    y2, h2 = tref.selective_scan(*ins2)
    outs2 = (y2, h2) if dh else (y2,)
    plain = torch.autograd.grad(outs2, ins2, cots)
    _held([p.numpy() for p in plain], [g.numpy() for g in got],
          f"{spec[0]} Function vs autograd")


def test_gradcheck_float64():
    """The Function's CPU branch in float64 against finite differences,
    both cotangents live."""
    rng = np.random.default_rng(3)
    b, s, d, n = 2, 7, 3, 4
    x = torch.from_numpy(rng.standard_normal((b, s, d)))
    dt = torch.from_numpy(rng.uniform(0.05, 0.6, (b, s, d)))
    bm = torch.from_numpy(rng.standard_normal((b, s, n)))
    cm = torch.from_numpy(rng.standard_normal((b, s, n)))
    a = torch.from_numpy(-rng.uniform(0.1, 1.1, (d, n)))
    ins = [t.requires_grad_() for t in (x, dt, bm, cm, a)]
    assert torch.autograd.gradcheck(ops.selective_scan, ins)


def test_forward_keeps_values_and_saves_only_operands():
    """The Function's forward is the plain scan bit for bit, and no
    trajectory is saved for backward: only the five operands."""
    spec = SPECS[1]
    ins = [_t(v).requires_grad_() for v in scan_arrays(spec)]
    y, h = ops.selective_scan(*ins)
    want = tref.selective_scan(*(t.detach() for t in ins))
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(s.shape == t.shape for s, t in zip(saved, ins))


def test_backward_kernel_refuses_cpu_tensors():
    args = [_t(v) for v in scan_arrays(SPECS[0])]
    with pytest.raises(ValueError, match="CUDA"):
        ssk.selective_scan_bwd(*args, torch.zeros_like(args[0]))
