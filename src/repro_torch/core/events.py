"""Address-Event word formats.

The PyTorch counterpart of the reference ``core/events.py``.  The paper
transmits 26-bit parallel Address-Events (AEs) between chips.  Two wire
formats live here:

* the *protocol* format — the raw address word, exactly as the
  transceiver drives it onto the shared AER bus (used by the SNN chip
  array and the co-simulation, where an event is "neuron X on core Y
  spiked").  Words are at most 26 bits, so they live in int32 tensors
  (the reference uses uint32; the values are the same).  Arithmetic
  runs in int64, so a core id that overflows the word wraps exactly as
  the reference's uint32 shift does before the mask.

* the *payload* format — a sparse (address, value) event of the AER
  compression path: a block-local 16-bit address and the bfloat16 bits
  of the value in one 32-bit wire word, ``idx << 16 | bf16``.  The
  reference keeps these words in uint32; here they are int64 tensors
  holding the same values (torch's uint32 support is thin).  The bf16
  rounding is done in integer arithmetic, round to nearest even, with
  every NaN made the reference's canonical ``0x7FC0 | sign << 15``
  (a float cast would give another NaN pattern: ``0xFFFF`` from
  PyTorch on the CPU, ``0x7FFF`` from CUDA's ``__float2bfloat16_rn``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AER_ADDR_BITS", "AER_ADDR_MASK", "EVENT_IDX_BITS",
           "EVENT_MAX_BLOCK", "pack_aer_address", "unpack_aer_address",
           "f32_to_bf16_bits", "bf16_bits_to_f32", "pack_events",
           "unpack_events", "event_bytes", "roundtrip_error_bound"]

AER_ADDR_BITS = 26  # width of the paper's parallel AER bus
AER_ADDR_MASK = (1 << AER_ADDR_BITS) - 1

# Payload ("ML") event word: [31:16] block-local address, [15:0] bf16 bits.
EVENT_IDX_BITS = 16
EVENT_MAX_BLOCK = 1 << EVENT_IDX_BITS


def _i64(x) -> torch.Tensor:
    """int64 tensor of ``x`` (a tensor keeps its device; numpy arrays,
    including uint32 ones, and Python ints land on the CPU)."""
    if torch.is_tensor(x):
        return x.to(torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def pack_aer_address(core, neuron, neuron_bits: int = 16) -> torch.Tensor:
    """Pack (core, neuron) into a 26-bit AER address word (int32).

    ``neuron_bits`` low bits hold the neuron id, the remaining
    ``26 - neuron_bits`` the core id (a hierarchical address; the paper
    prescribes no split)."""
    core, neuron = _i64(core), _i64(neuron)
    word = (core << neuron_bits) | (neuron & ((1 << neuron_bits) - 1))
    return (word & AER_ADDR_MASK).to(torch.int32)


def unpack_aer_address(word, neuron_bits: int = 16):
    """26-bit word -> ``(core, neuron)``, int32 tensors."""
    word = _i64(word) & AER_ADDR_MASK
    neuron = word & ((1 << neuron_bits) - 1)
    core = word >> neuron_bits
    return core.to(torch.int32), neuron.to(torch.int32)


# --- payload format: (idx:16 | bf16:16) -> 32-bit word (int64) ---------

def _f32_bits(val) -> torch.Tensor:
    """The float32 bit pattern of ``val`` as int64 in [0, 2**32)."""
    if not torch.is_tensor(val):
        val = torch.from_numpy(np.asarray(val, np.float32))
    v = val.to(torch.float32).contiguous()
    return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def f32_to_bf16_bits(val) -> torch.Tensor:
    """float32 -> int64 holding the bf16 bit pattern (0..0xFFFF), rounded
    to nearest even; a NaN becomes ``0x7FC0 | sign << 15`` whatever its
    payload, as the reference's ``astype(jnp.bfloat16)`` gives.  Other
    dtypes are converted to float32 first (exactly, for bf16)."""
    b = _f32_bits(val)
    sign = b >> 31
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    rne = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return torch.where(nan, 0x7FC0 | (sign << 15), rne & 0xFFFF)


def bf16_bits_to_f32(bits) -> torch.Tensor:
    """bf16 bit patterns (the low 16 bits of ``bits``) -> float32, exactly:
    the bits move to the top half of the float32 word, NaN payloads
    included, as the reference's bitcast and widening do."""
    w = (_i64(bits) & 0xFFFF) << 16
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).view(torch.float32)


def pack_events(idx, val) -> torch.Tensor:
    """Pack block-local indices (taken mod 2**16) and values into 32-bit
    wire words, held in int64 tensors: ``(idx & 0xFFFF) << 16 | bf16``.
    Values are rounded to bf16 — the precision actually shipped on the
    wire.  Words equal the reference's uint32 words value for value."""
    idx16 = _i64(idx) & 0xFFFF
    return (idx16 << 16) | f32_to_bf16_bits(val).to(idx16.device)


def unpack_events(words):
    """Wire words (int64 here; a uint32 array or an int32 view of one is
    taken too) -> ``(idx int32, val float32 of bf16 precision)``."""
    w = _i64(words) & 0xFFFFFFFF
    return (w >> 16).to(torch.int32), bf16_bits_to_f32(w)


def event_bytes(n_events, word_bytes: int = 4):
    """Wire bytes for an event stream (the 'pins -> bytes' accounting)."""
    return n_events * word_bytes


def roundtrip_error_bound() -> float:
    """Max relative error introduced by bf16 payload quantisation."""
    return 2.0 ** -8  # bf16 has 8 mantissa bits incl. implicit one
