"""Address-Event word formats: the protocol half.

The PyTorch counterpart of the reference ``core/events.py``.  The paper
transmits 26-bit parallel Address-Events (AEs) between chips; the
*protocol* format is that raw address word, exactly as the transceiver
drives it onto the shared AER bus (used by the SNN chip array and the
co-simulation, where an event is "neuron X on core Y spiked").

Words are at most 26 bits, so they live in int32 tensors (the reference
uses uint32; the values are the same).  Arithmetic runs in int64, so a
core id that overflows the word wraps exactly as the reference's uint32
shift does before the mask.

The reference's *payload* format (block-local index plus bf16 value bits
per uint32 word, ``pack_events`` / ``unpack_events``) belongs to the AER
compression path and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AER_ADDR_BITS", "AER_ADDR_MASK", "EVENT_IDX_BITS",
           "EVENT_MAX_BLOCK", "pack_aer_address", "unpack_aer_address",
           "event_bytes"]

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


def event_bytes(n_events, word_bytes: int = 4):
    """Wire bytes for an event stream (the 'pins -> bytes' accounting)."""
    return n_events * word_bytes
