"""CUDA kernel of the Mamba selective scan (Hopper, sm_90a).

Source: ``csrc/selective_scan.cu``, built by ``_build`` into a library
of its own at first use.  Replaces ``selective_scan_pallas``
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
once per kernel launch and nowhere else).  The kernel has no backward:
it refuses operands that need a gradient.  ``ops.selective_scan`` sends
CPU tensors to ``ref.selective_scan``.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["selective_scan", "MAX_STATE"]

#: the widest state the kernel takes
MAX_STATE = 32


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                   c_ssm: torch.Tensor, a: torch.Tensor):
    """The S6 scan on the card; returns ``(y, h_final)`` in float32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan launches a CUDA kernel; got a "
                         f"tensor on {dev} (ops.selective_scan runs the "
                         f"plain version on the CPU)")
    _build.check_operands("selective_scan", dev, torch.float32, x=x, dt=dt,
                          b_ssm=b_ssm, c_ssm=c_ssm, a=a)
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"selective_scan: x must be (B, S, d_in) and a "
                         f"(d_in, N), got {tuple(x.shape)} and "
                         f"{tuple(a.shape)}")
    bsz, seq, d_in = x.shape
    n = a.shape[1]
    if dt.shape != x.shape or a.shape[0] != d_in or \
            b_ssm.shape != (bsz, seq, n) or c_ssm.shape != (bsz, seq, n):
        raise ValueError(
            f"selective_scan: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, b {tuple(b_ssm.shape)}, c "
            f"{tuple(c_ssm.shape)}, a {tuple(a.shape)} do not fit "
            f"(B, S, d_in), (B, S, d_in), (B, S, N), (B, S, N), (d_in, N)")
    if bsz > 65535:
        raise ValueError(f"selective_scan: B = {bsz}; the kernel takes at "
                         f"most 65535 sequences a launch")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: N = {n}; the kernel takes 1 to "
                         f"{MAX_STATE} states a channel")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, b_ssm, c_ssm, a)):
        raise RuntimeError("selective_scan: the kernel has no backward "
                           "yet (training is not ported); run it under "
                           "torch.no_grad()")
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
