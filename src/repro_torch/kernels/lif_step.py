"""CUDA kernel of the LIF membrane update (Hopper, sm_90a).

Source: ``csrc/lif_step.cu``, built by ``_build`` into a library of its
own at first use.  Replaces ``lif_step_pallas``
(``src/repro/kernels/lif_step.py:29``, body ``_lif_kernel`` at ``:20``).

    v2 = fma(v, decay, i_syn); spike = v2 >= v_th;
    v_next = v_reset where spike else v2; spikes = 1.0 where spike else 0.0

Design: over contiguous float32 state of any shape (the callers pass
``(rows, 128·k)``), a thread takes four neurons a trip as 16-byte
vectors when all four arrays are 16-byte aligned, and the 0-3 neurons
past the last vector (or the whole array, when an operand starts
elsewhere, such as a view at an odd storage offset) in the same
kernel's scalar loop; the grid is at most one full wave of the card's
SMs, each thread striding over the rest.  The fused multiply-add is
written out (``fmaf``), because the reference runs under ``jax.jit``,
where XLA contracts ``v * decay + i`` into one rounding; the plain
version in ``ref.lif_step`` computes the same single rounding in
float64.  Bound on an H100: bytes, 16 per neuron (two float32 reads,
two writes) at 3.35 TB/s — at the cosim ring-16 shape (16, 128) that
is 32 KB, ~0.01 µs, far below a launch.

The wrapper checks its operands (CUDA, float32, contiguous, one shape),
allocates the outputs with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises on a CUDA error, and counts
its launches (``lif_step.launches``, bumped once per kernel launch and
nowhere else).  ``ops.lif_step`` sends CPU tensors to ``ref.lif_step``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lif_step"]


def lif_step(v: torch.Tensor, i_syn: torch.Tensor, *, decay: float,
             v_th: float, v_reset: float):
    """Fused LIF update on the card; returns ``(v_next, spikes)``, both
    float32 in ``v``'s shape (spikes are 0.0 / 1.0)."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"lif_step launches a CUDA kernel; got a tensor on "
                         f"{dev} (ops.lif_step runs the plain version on "
                         f"the CPU)")
    _build.check_operands("lif_step", dev, torch.float32, v=v, i_syn=i_syn)
    if i_syn.shape != v.shape:
        raise ValueError(f"lif_step: v {tuple(v.shape)} and i_syn "
                         f"{tuple(i_syn.shape)} must share one shape")
    v_next = torch.empty_like(v)
    spikes = torch.empty_like(v)
    n = v.numel()
    if n == 0:
        return v_next, spikes
    lib = _build.load("lif_step")
    # ctypes.c_float rounds each parameter to float32 (nearest), as the
    # reference's jnp.asarray(x, v.dtype) does
    rc = lib.lif_step_launch(
        v.data_ptr(), i_syn.data_ptr(), n, ctypes.c_float(decay),
        ctypes.c_float(v_th), ctypes.c_float(v_reset), v_next.data_ptr(),
        spikes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "lif_step")
    lif_step.launches += 1
    return v_next, spikes


lif_step.launches = 0
