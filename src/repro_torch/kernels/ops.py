"""Device dispatch of the port's kernels, and the AER compress path
around the encoder and decoder.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain version in ``ref``.  The kernels
of the LM paths (B5, B6 and B7 with its backward) also take ``meta``
tensors, the dry-run's abstract device: a shape-only route returns
``torch.empty`` outputs of the kernel's shapes and dtypes.  The fabric
kernels (B1-B4) refuse ``meta``.  Each LM kernel runs inside
``launch.cost.kernel``, which reports its operand and result bytes to an
active counter whatever the route.  There is no environment override
and no fallback: on the card the plain path is reached only when the
caller asks for it — ``engine="reference"`` of the fabric, or a direct
call of ``ref``.

The compress path (the counterpart of the reference's
``kernels/ops.py:33-139``) flattens and zero-pads a tensor into
(num_blocks, block) tiles, picks a per-block threshold that keeps about
``frac`` of the entries, encodes the tiles into fixed-width event slots
(``EventBlocks``) and decodes them back; ``compress_with_feedback``
keeps what did not ship as an error-feedback residual.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import events as ev
from ..launch import cost
from . import aer_decode as adk
from . import aer_encode as aek
from . import fabric_queue as fq
from . import lif_step as lk
from . import ref
from . import selective_scan as ssk

__all__ = ["fabric_queue_scan", "fabric_queue_update",
           "fabric_queue_multistep", "lif_step", "aer_encode",
           "aer_decode", "selective_scan", "DEFAULT_BLOCK",
           "DEFAULT_BUDGET", "EventBlocks",
           "pad_to_blocks", "unpad_from_blocks", "tau_from_fraction",
           "aer_compress", "aer_decompress", "compress_with_feedback"]

DEFAULT_BLOCK = 1024
DEFAULT_BUDGET = 128


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """The fabric kernels' route: True on CUDA, False on the CPU; any
    other device (``meta`` too) is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}; it takes "
                     f"cuda or cpu tensors")


def _route(t: torch.Tensor, name: str) -> str:
    """An LM kernel's route: ``"cuda"``, ``"cpu"`` or ``"meta"``."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"{name}: unsupported device {t.device}; it takes "
                     f"cuda, cpu or meta tensors")


def _meta_encode(x, tau, budget: int):
    nb = x.shape[0]
    i32 = dict(dtype=torch.int32, device=x.device)
    return (torch.empty((nb, budget), **i32),
            torch.empty((nb, budget), dtype=x.dtype, device=x.device),
            torch.empty((nb,), **i32), torch.empty((nb,), **i32))


def _meta_decode(idx, val, block: int):
    return torch.empty((idx.shape[0], block), dtype=val.dtype,
                       device=val.device)


_ENCODE = {"cuda": aek.aer_encode, "cpu": ref.aer_encode,
           "meta": _meta_encode}
_DECODE = {"cuda": adk.aer_decode, "cpu": ref.aer_decode,
           "meta": _meta_decode}


def fabric_queue_scan(q_time, q_dest, t_q):
    """Per-queue ``(pend, r_min, nxt, amin, busy, head_route)``."""
    if _on_cuda(q_time, "fabric_queue_scan"):
        return fq.fabric_queue_step(q_time, q_dest, t_q)
    return ref.fabric_queue_scan(q_time, q_dest, t_q)


def fabric_queue_update(q_time, q_dest, q_inj, pop_q, pop_slot,
                        app_q, app_slot, app_t, app_dest, app_inj):
    """Pop-consume + forward-append, in place on the three planes."""
    args = (q_time, q_dest, q_inj, pop_q, pop_slot, app_q, app_slot, app_t,
            app_dest, app_inj)
    if _on_cuda(q_time, "fabric_queue_update"):
        return fq.fabric_queue_update(*args)
    return ref.fabric_queue_update(*args)


def fabric_queue_multistep(carry, consts, base, *, step_fn, chunk: int,
                           max_steps: int, max_burst: int):
    """``min(chunk, max_steps - base)`` micro-transactions on the packed
    carry.  On CUDA one launch of the Hopper kernel, which carries the
    step itself (``step_fn`` is not used) and updates the carry in
    place; on the CPU the plain loop of ``step_fn``."""
    if _on_cuda(carry[0], "fabric_queue_multistep"):
        return fq.fabric_queue_multistep(carry, consts, base, chunk=chunk,
                                         max_steps=max_steps,
                                         max_burst=max_burst)
    return ref.fabric_queue_multistep(carry, consts, base, step_fn=step_fn,
                                      chunk=chunk, max_steps=max_steps)


def lif_step(v, i_syn, *, decay: float = 0.9, v_th: float = 1.0,
             v_reset: float = 0.0):
    """Fused LIF update on (rows, lanes) float32 state; returns
    ``(v_next, spikes)``."""
    if not _on_cuda(v, "lif_step"):
        return ref.lif_step(v, i_syn, decay, v_th, v_reset)
    return lk.lif_step(v, i_syn, decay=decay, v_th=v_th, v_reset=v_reset)


def aer_encode(x, tau, budget: int):
    """Encode (nb, block) tiles into event slots; ``tau`` is (nb,) in x's
    dtype.  Returns ``(idx, val, count, wanted)``."""
    route = _route(x, "aer_encode")
    with cost.kernel("aer_encode") as k:
        return k.record((x, tau), _ENCODE[route](x, tau, budget))


def aer_decode(idx, val, block: int):
    """Decode (nb, budget) event slots into (nb, block) of val's dtype."""
    route = _route(idx, "aer_decode")
    with cost.kernel("aer_decode") as k:
        return k.record((idx, val), _DECODE[route](idx, val, block))


def selective_scan(x, dt, b_ssm, c_ssm, a):
    """The Mamba S6 scan: x, dt (B, S, d_in), b_ssm/c_ssm (B, S, N), a
    (d_in, N), float32.  Returns ``(y (B, S, d_in), h_final (B, d_in,
    N))``, differentiable: through ``SelectiveScanFn``, whose forward and
    backward are B7 and its backward kernel on CUDA tensors, the plain
    versions on CPU tensors and the shape-only routes on meta tensors."""
    _route(x, "selective_scan")
    return ssk.SelectiveScanFn.apply(x, dt, b_ssm, c_ssm, a)


# --- the AER compress path ---------------------------------------------

class EventBlocks(NamedTuple):
    """A compressed tensor: fixed-width AER event slots per block."""
    idx: torch.Tensor     # (num_blocks, budget) int32, -1 = void
    val: torch.Tensor     # (num_blocks, budget) float
    count: torch.Tensor   # (num_blocks,) int32 — events emitted
    wanted: torch.Tensor  # (num_blocks,) int32 — events over threshold

    @property
    def wire_words(self) -> torch.Tensor:
        """The packed wire words ((idx:16 | bf16:16), ``events.py``
        format) as int64 tensors, void slots at address 0."""
        return ev.pack_events(self.idx.clamp(min=0), self.val)

    def wire_bytes(self) -> torch.Tensor:
        """Bytes on the wire under run-length framing: only ``count``
        slots a block ship (void slots are never driven onto the bus),
        plus one 4-byte count word a block."""
        return self.count.sum(dtype=torch.int64) * 4 + \
            self.count.shape[0] * 4


def pad_to_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Flatten and zero-pad to (num_blocks, block).  Returns
    ``(tiles, orig_size)``; at least one block, as in the reference."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = max(1, -(-n // block))
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, block), n


def unpad_from_blocks(tiles: torch.Tensor, orig_size: int, shape):
    return tiles.reshape(-1)[:orig_size].reshape(shape)


#: entries a chunk of ``tau_from_fraction``'s rows (256 MB of float32)
TAU_CHUNK = 1 << 26


def tau_from_fraction(x_tiles: torch.Tensor, frac: float) -> torch.Tensor:
    """Per-block threshold that keeps about ``frac`` of the entries: the
    ``1 - frac`` quantile of ``|x|`` along each row, in x's dtype.

    The reference's ``jnp.quantile`` rule, written out in float32:
    ``q = float32(clip(1 - frac, 0, 1))``, ``h = q * (n - 1)``, and
    ``s[floor h] * (1 - w) + s[ceil h] * w`` with ``w = h - floor h`` on
    the sorted row ``s``; a row that holds a NaN gets NaN.  XLA fuses
    the last line into ``fma(s[floor h], 1 - w, s[ceil h] * w)``, which
    the float64 route below rounds once, as the FMA does, except on a
    double rounding; ``tests/test_torch_aer.py`` holds it to within one
    float32 ulp of the reference.  Rows go through in chunks of about
    ``TAU_CHUNK`` entries, so the sort's copies of a billion-entry
    gradient (values and int64 indices) need not fit beside it; each
    row's value does not depend on the chunking.
    """
    rows = max(1, TAU_CHUNK // max(1, x_tiles.shape[1]))
    if x_tiles.shape[0] > rows:
        return torch.cat([tau_from_fraction(x_tiles[i:i + rows], frac)
                          for i in range(0, x_tiles.shape[0], rows)])
    a = x_tiles.float().abs()
    n = a.shape[1]
    a = torch.where(torch.isnan(a).any(1, keepdim=True), float("nan"), a)
    s = a.sort(1).values
    q = np.float32(min(max(1.0 - frac, 0.0), 1.0))
    h = q * np.float32(n - 1)
    lo, hi = np.floor(h), np.ceil(h)
    w_hi = h - lo
    w_lo = np.float32(1) - w_hi
    lo = int(min(max(lo, 0), n - 1))
    hi = int(min(max(hi, 0), n - 1))
    # the product of two float32 values is exact in float64
    tau = (s[:, lo].double() * float(w_lo)
           + (s[:, hi] * float(w_hi)).double()).float()
    return tau.to(x_tiles.dtype)


def _row_tau(tau, x_tiles: torch.Tensor) -> torch.Tensor:
    """``tau`` (one value, or one a row) as a contiguous (nb,) tensor in
    the tiles' dtype, as the reference's ``jnp.asarray(tau, x.dtype)``
    broadcast."""
    nb = x_tiles.shape[0]
    t = torch.as_tensor(tau, device=x_tiles.device).to(x_tiles.dtype)
    t = t.reshape(-1)
    if t.numel() == 1:
        t = t.expand(nb)
    if t.shape != (nb,):
        raise ValueError(f"tau must be one value or ({nb},), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def aer_compress(x_tiles: torch.Tensor, tau,
                 budget: int = DEFAULT_BUDGET) -> EventBlocks:
    """Encode (num_blocks, block) tiles into event slots: B5 on the card,
    its plain version on the CPU."""
    return EventBlocks(*aer_encode(x_tiles, _row_tau(tau, x_tiles), budget))


def aer_decompress(events_: EventBlocks,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Event slots back to dense (num_blocks, block) tiles: B6 on the
    card, its plain version on the CPU."""
    return aer_decode(events_.idx, events_.val, block)


def compress_with_feedback(x: torch.Tensor, residual: torch.Tensor, *,
                           frac: float = 0.05, budget: int = DEFAULT_BUDGET,
                           block: int = DEFAULT_BLOCK):
    """Error-feedback AER compression of one tensor.

    ``y = x + residual``; ``events = encode(y)``; ``residual' = y -
    decode(events)``.  Returns ``(EventBlocks, new_residual,
    orig_size)``.
    """
    y = x + residual
    tiles, n = pad_to_blocks(y, block)
    tau = tau_from_fraction(tiles, frac)
    events_ = aer_compress(tiles, tau, budget)
    dec = aer_decompress(events_, block)
    new_res = unpad_from_blocks(tiles - dec, n, x.shape)
    return events_, new_res, n
