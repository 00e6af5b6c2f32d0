"""CUDA kernels of the Mamba selective scan and its gradient (Hopper,
sm_90a), and the autograd Function that joins them.

Forward source: ``csrc/selective_scan.cu``, built by ``_build`` into a
library of its own at first use.  Replaces ``selective_scan_pallas``
(``src/repro/kernels/selective_scan.py:51``, body ``_scan_kernel`` at
``:29``):

    h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·x_t) ⊗ B_t,  h_0 = 0
    y_t = Σ_n h_t·C_t

on x, dt (B, S, d_in), B/C (B, S, N) and A (d_in, N), all float32;
returns ``(y (B, S, d_in), h_final (B, d_in, N))``.

Design (``csrc/selective_scan.cu`` says more): a channel (b, d) belongs
to two threads (one where N = 1), which hold its states' h in registers
for the whole sequence, form dt·x once a step and sum h·C in registers
(in the first version's butterfly order); a block of 128 threads walks
the sequence in 32-step tiles of dt, x, B and C that arrive by
``cp.async`` into a two-stage ring in shared memory, and writes y
through a staged tile.  Any N from 1 to 32, any d_in, B <= 65535.
Bound on an H100 at the serve shape (4, 2048, 8192, 16): the 1.07e9
exponentials (0.257 ms on the special function units) over the 809.0 MB
moved (0.241 ms at 3.35 TB/s).

The wrapper checks its operands (CUDA, float32, contiguous, matching
shapes, 1 <= N <= 32), allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream without synchronising, raises on a
CUDA error, and counts its launches (``selective_scan.launches``, bumped
once per kernel launch and nowhere else).

Backward source: ``csrc/selective_scan_bwd.cu``, a kernel that replaces
no TPU kernel (the reference differentiates its jnp scan; the port's
scan is B7, so its gradient is a kernel of its own).  Given dy and
dh_final it returns ``(dx, ddt, db, dc, da)``; it rebuilds the forward
states from a scratch of tile-entry states (B, S/8, L, d_in), walks the
tiles backwards with each tile's operands staged in shared memory, and
sums dB, dC and dA without atomics in a fixed order, so its results are
the same bits on every run.  Each call of
``selective_scan_bwd`` is one launch of the scan kernel followed by one
of its fixed-order reduction, counted once (``selective_scan_bwd
.launches``).  Bound at (4, 2048, 8192, 16): 1.345 GB moved, 0.401 ms
at 3.35 TB/s; it takes ~3.7 ms there on an H100.

``SelectiveScanFn`` is the ``torch.autograd.Function`` of the scan: on
CUDA tensors its forward is B7 and its backward the kernel above; on CPU
tensors its forward is ``ref.selective_scan`` and its backward
``ref.selective_scan_bwd``.  ``ops.selective_scan`` calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["selective_scan", "selective_scan_bwd", "bwd_plan",
           "SelectiveScanFn", "MAX_STATE"]

#: the widest state the kernel takes
MAX_STATE = 32


def _check(name: str, x, dt, b_ssm, c_ssm, a, **more) -> None:
    """The operand contract of both kernels: CUDA, float32, contiguous,
    (B, S, d_in) x and dt, (B, S, N) B and C, (d_in, N) A, B <= 65535,
    1 <= N <= 32; ``more`` are (B, S, d_in) / (B, d_in, N) cotangents."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got a tensor on "
                         f"{dev} (ops.selective_scan runs the plain "
                         f"version on the CPU)")
    _build.check_operands(name, dev, torch.float32, x=x, dt=dt,
                          b_ssm=b_ssm, c_ssm=c_ssm, a=a, **more)
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"{name}: x must be (B, S, d_in) and a (d_in, N), "
                         f"got {tuple(x.shape)} and {tuple(a.shape)}")
    bsz, seq, d_in = x.shape
    n = a.shape[1]
    if dt.shape != x.shape or a.shape[0] != d_in or \
            b_ssm.shape != (bsz, seq, n) or c_ssm.shape != (bsz, seq, n):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, b {tuple(b_ssm.shape)}, c "
            f"{tuple(c_ssm.shape)}, a {tuple(a.shape)} do not fit "
            f"(B, S, d_in), (B, S, d_in), (B, S, N), (B, S, N), (d_in, N)")
    want = {"dy": x.shape, "dh_final": (bsz, d_in, n)}
    for arg, t in more.items():
        if t.shape != want[arg]:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)}, expected "
                             f"{tuple(want[arg])}")
    if bsz > 65535:
        raise ValueError(f"{name}: B = {bsz}; the kernel takes at most "
                         f"65535 sequences a launch")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{name}: N = {n}; the kernel takes 1 to "
                         f"{MAX_STATE} states a channel")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                   c_ssm: torch.Tensor, a: torch.Tensor):
    """The S6 scan on the card; returns ``(y, h_final)`` in float32."""
    _check("selective_scan", x, dt, b_ssm, c_ssm, a)
    dev = x.device
    bsz, seq, d_in = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, d_in, n), dtype=torch.float32, device=dev)
    if bsz * d_in == 0:
        return y, h_final
    lib = _build.load("selective_scan")
    rc = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), bsz, seq, d_in, n, y.data_ptr(), h_final.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "selective_scan")
    selective_scan.launches += 1
    return y, h_final


selective_scan.launches = 0


@functools.cache
def bwd_plan(n_state: int) -> dict:
    """The backward kernel's layout for ``n_state`` states, as the
    library reports it: channels a block, steps a tile, and L (N rounded
    up to a power of two)."""
    lib = _build.load("selective_scan_bwd")
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.selective_scan_bwd_plan(n_state, out),
                 "selective_scan_bwd_plan")
    return {"channels": out[0], "tile": out[1], "states": out[2]}


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor,
                       b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                       a: torch.Tensor, dy: torch.Tensor,
                       dh_final: torch.Tensor | None = None):
    """The scan's gradient on the card: ``(dx, ddt, db, dc, da)`` in
    float32 from the forward's operands, ``dy`` (B, S, d_in) and
    ``dh_final`` (B, d_in, N) (None: zeros)."""
    more = {"dy": dy} if dh_final is None else {"dy": dy,
                                                "dh_final": dh_final}
    _check("selective_scan_bwd", x, dt, b_ssm, c_ssm, a, **more)
    dev = x.device
    bsz, seq, d_in = x.shape
    n = a.shape[1]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b_ssm), torch.empty_like(c_ssm)
    if seq == 0:
        return dx, ddt, db, dc, torch.zeros_like(a)
    plan = bwd_plan(n)
    tiles = -(-seq // plan["tile"])
    nblk = -(-d_in // plan["channels"])
    f32 = dict(dtype=torch.float32, device=dev)
    hb = torch.empty(bsz * tiles * plan["states"] * d_in, **f32)
    pb = torch.empty((bsz, nblk, seq, n), **f32)
    pc = torch.empty((bsz, nblk, seq, n), **f32)
    pa = torch.empty((bsz, d_in, n), **f32)
    da = torch.empty_like(a)
    lib = _build.load("selective_scan_bwd")
    rc = lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), dy.data_ptr(),
        None if dh_final is None else dh_final.data_ptr(),
        bsz, seq, d_in, n, hb.data_ptr(), pb.data_ptr(), pc.data_ptr(),
        pa.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(),
        dc.data_ptr(), da.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dx, ddt, db, dc, da


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """``(y, h_final) = scan(x, dt, b_ssm, c_ssm, a)`` with its gradient.
    The forward saves only its operands; the backward recomputes the
    states it needs.  CUDA tensors go to the kernels, CPU tensors to the
    plain versions in ``ref``; there is no other path."""

    @staticmethod
    def forward(ctx, x, dt, b_ssm, c_ssm, a):
        ctx.save_for_backward(x, dt, b_ssm, c_ssm, a)
        if x.device.type == "cuda":
            return selective_scan(x, dt, b_ssm, c_ssm, a)
        return ref.selective_scan(x, dt, b_ssm, c_ssm, a)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, b_ssm, c_ssm, a = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        if x.device.type == "cuda":
            return selective_scan_bwd(x, dt, b_ssm, c_ssm, a, dy, dh_final)
        return ref.selective_scan_bwd(x, dt, b_ssm, c_ssm, a, dy, dh_final)
