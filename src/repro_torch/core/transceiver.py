"""SW_Control FSM of the bi-directional AE transceiver block (paper §II–III).

The PyTorch counterpart of the reference ``core/transceiver.py``; see
there for the signal conventions, the Table I mode resolution and the
``max_burst`` fairness extension.  Every function is elementwise over
int32 tensors of any one shape: a scalar tensor is one block, an (L,)
tensor is the L blocks of a fabric's links (what ``vmap`` did in JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RX, TX = 0, 1

_I32 = torch.int32


class XcvrState(NamedTuple):
    mode: torch.Tensor    # int32: 0 = RX, 1 = TX
    sw_ack: torch.Tensor  # int32: own state wire
    rx_p: torch.Tensor    # int32: received >= 1 event since entering RX
    burst: torch.Tensor   # int32: consecutive events sent in TX tenure


def reset_state(initial_mode, device=None) -> XcvrState:
    """Chip-level global reset.  ``initial_mode`` is an int or an int
    tensor (one mode per block); exactly one block of a linked pair is
    reset into TX, and the RX block gets ``rx_p = 1`` (the paper's reset
    exemption)."""
    mode = torch.as_tensor(initial_mode, dtype=_I32, device=device)
    return XcvrState(mode=mode, sw_ack=mode.clone(), rx_p=1 - mode,
                     burst=torch.zeros_like(mode))


class XcvrOut(NamedTuple):
    tx_en: torch.Tensor
    rx_en: torch.Tensor
    switched: torch.Tensor  # 1 iff mode changed this step


def step(state: XcvrState, sw_req, tx_pending, rx_strobe,
         max_burst: int = 0):
    """One FSM evaluation (see the reference for the guards).

    ``sw_req`` / ``tx_pending`` are int32 tensors shaped like the state;
    ``rx_strobe`` is such a tensor or a plain int; ``max_burst`` is a
    plain int (0 = paper-faithful grant rule) or an int tensor that
    broadcasts against the state (one bound per block, as a batch of
    fabrics with different queue policies has).  Returns
    ``(new_state, XcvrOut)``.
    """
    new = settle(state, sw_req, tx_pending, rx_strobe, max_burst)
    out = XcvrOut(tx_en=(new.mode == TX).to(_I32),
                  rx_en=(new.mode == RX).to(_I32),
                  switched=(new.mode != state.mode).to(_I32))
    return new, out


def settle(state: XcvrState, sw_req, tx_pending, rx_strobe,
           max_burst: int = 0) -> XcvrState:
    """The new state of :func:`step`, without its outputs (what the link
    micro-transaction reads).  ``mode``, ``sw_ack``, ``rx_p``,
    ``sw_req`` and ``rx_strobe`` are 0/1, as the FSM and the link
    produce them, so the guards are boolean algebra over them: each
    ``torch.where`` on a Python number would cost a fill kernel on the
    card, where a fabric step is a chain of small launches."""
    is_rx = state.mode == RX
    is_tx = ~is_rx
    tx_p = tx_pending > 0

    # RX_Probe latches on any receive while in RX mode (a plain-int 0
    # strobe, the settle iteration's, cannot latch: skip the ops)
    rx_p = state.rx_p
    if torch.is_tensor(rx_strobe) or rx_strobe:
        rx_p = rx_p | (is_rx & (rx_strobe == 1))

    want_request = is_rx & tx_p & (rx_p == 1)
    drained = ~tx_p
    if torch.is_tensor(max_burst):
        drained = drained | ((max_burst > 0) & (state.burst >= max_burst))
    elif max_burst > 0:
        drained = drained | (state.burst >= max_burst)
    req = sw_req == 1
    want_grant = is_tx & req & drained
    ack = torch.where(is_tx, ~want_grant, want_request)

    # Table I mode resolution: ack & ~req -> TX, ~ack & req -> RX, else
    # hold
    tx_now = (ack & ~req) | (is_tx & (ack | ~req))

    # entering RX afresh clears the probe; burst clears on any switch
    return XcvrState(mode=tx_now.to(_I32), sw_ack=ack.to(_I32),
                     rx_p=rx_p & (is_rx | tx_now),
                     burst=state.burst * (tx_now == is_tx))
