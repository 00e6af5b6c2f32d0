"""Link timing / energy model — the measured contract of the fabricated block.

Plain numpy: the port's own copy of the reference package's
``core/link.py``, so that importing the port never pulls JAX in.

Constants are the chip measurements from paper §IV (28 nm FDSOI, 1 V):

  t_sw       ≈ 5 ns   direction-switch latency (TX/RX_EN flip)
  t_sw2req   ≈ 5 ns   switch-complete → first request asserted
  t_req2req  ≈ 31 ns  steady-state same-direction event cycle
                      → 1/31 ns = 32.3 MEvents/s (Fig. 7)
  t_bidir    ≈ 35 ns  per-event cycle when direction alternates every event
                      → 1/35 ns = 28.6 MEvents/s worst case (Fig. 8)
  e_event    ≈ 11 pJ  per delivered 26-bit event (excl. pad drivers)

The bidirectional cycle is NOT t_req2req + t_sw + t_sw2req (= 41 ns): the
grant/switch phases overlap the return-to-zero tail of the previous 4-phase
handshake.  We model the overlap explicitly: a reversal adds
``t_reverse_penalty = t_bidir - t_req2req = 4 ns`` on top of the steady
cycle, while a switch out of an *idle* bus pays the full, un-overlapped
t_sw + t_sw2req = 10 ns before the first request.

All times are integer nanoseconds so the discrete-event simulator is exact.

Per-link heterogeneity
----------------------
Real multi-chip AER systems mix link classes — fast parallel on-board
buses next to slow bit-serial LVDS inter-board links (Qiao & Indiveri
2019), hierarchical stages with different wire budgets (DYNAPs).  A
``LinkTiming`` therefore accepts *arrays* in every field: a
structure-of-arrays instance of shape ``(L,)`` gives link ``l`` the
timing contract ``timing[l]`` (see :func:`per_link_timing` /
:meth:`LinkTiming.for_links`).  A scalar instance means "every link
identical" — the fabric engines normalise both forms through
:func:`link_timing_arrays` and a uniform per-link array is bit-exactly
equivalent to the scalar it broadcasts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LinkTiming:
    t_sw_ns: int = 5            # direction switch
    t_sw2req_ns: int = 5        # switch -> first request
    t_req2req_ns: int = 31      # same-direction event cycle
    t_bidir_ns: int = 35        # alternating-direction event cycle
    e_event_pj: float = 11.0    # energy per delivered event
    word_bits: int = 26         # parallel AER bus width

    @property
    def t_reverse_penalty_ns(self) -> int:
        """Extra cost of an event whose direction differs from the previous
        event on a busy bus (handshake-overlapped switch)."""
        return self.t_bidir_ns - self.t_req2req_ns

    @property
    def t_idle_switch_ns(self) -> int:
        """Cost of flipping an idle bus before the first request."""
        return self.t_sw_ns + self.t_sw2req_ns

    # --- derived figures of merit (Table II checks) ---------------------

    def onedir_throughput_mev_s(self) -> float:
        return 1e3 / self.t_req2req_ns  # events / us -> MEvents/s

    def bidir_throughput_mev_s(self) -> float:
        return 1e3 / self.t_bidir_ns

    def energy_nj(self, n_events: int) -> float:
        return self.e_event_pj * n_events * 1e-3

    def io_pins_saved(self, n_links: int = 4) -> int:
        """Pins saved vs. two unidirectional parallel buses per link.

        One link needs ``word_bits`` data + 2 handshake wires per direction;
        sharing the data bus saves ``word_bits`` pins per link (the SW wires
        replace one req/ack pair).  The paper reports 100 I/Os saved with
        transceivers on all four chip borders of a 180-I/O prototype.
        """
        return n_links * (self.word_bits - 1)  # 4*25 = 100, as measured

    # --- "sub-words" extension (paper §V conclusions) -------------------

    def subword(self, factor: int) -> "LinkTiming":
        """The paper's proposed combination with 'sub-words': serialize
        each ``word_bits`` event over ``factor`` bus beats of
        ``word_bits/factor`` wires.  Pins shrink by ~factor; the event
        cycle stretches by the extra beats (the matched-delay data phase
        repeats per beat while the 4-phase overhead is paid once), so
        throughput degrades sub-linearly — the paper's argument for why
        sub-words beat full bit-serial LVDS on latency.
        """
        assert self.word_bits % factor == 0, (self.word_bits, factor)
        # split the measured cycle into handshake overhead + data phase
        data_phase = 12  # ns of the 31 ns cycle that scales with beats
        overhead = self.t_req2req_ns - data_phase
        cyc = overhead + data_phase * factor
        return LinkTiming(
            t_sw_ns=self.t_sw_ns, t_sw2req_ns=self.t_sw2req_ns,
            t_req2req_ns=cyc,
            t_bidir_ns=cyc + self.t_reverse_penalty_ns,
            e_event_pj=self.e_event_pj,   # same charge moved, fewer wires
            word_bits=self.word_bits // factor)

    # --- per-link heterogeneity ----------------------------------------

    @property
    def is_scalar(self) -> bool:
        """True when every field is a plain scalar (one shared contract)."""
        return all(np.ndim(getattr(self, f)) == 0 for f in _TIMING_FIELDS)

    def for_links(self, n_links: int) -> "LinkTiming":
        """Broadcast to an explicit structure-of-arrays of shape (L,)."""
        return LinkTiming(**{
            f: np.broadcast_to(np.asarray(getattr(self, f)),
                               (n_links,)).copy()
            for f in _TIMING_FIELDS})


_TIMING_FIELDS = ("t_sw_ns", "t_sw2req_ns", "t_req2req_ns", "t_bidir_ns",
                  "e_event_pj", "word_bits")


def per_link_timing(classes, assignment) -> LinkTiming:
    """Compose link classes into one structure-of-arrays ``LinkTiming``.

    ``classes`` is a sequence of scalar ``LinkTiming`` contracts (e.g. the
    paper's parallel bus next to a bit-serial LVDS class built with
    ``subword``); ``assignment[l]`` names the class of link ``l``.
    """
    idx = np.asarray(assignment, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"assignment must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= len(classes)):
        raise ValueError(f"assignment indexes {len(classes)} classes "
                         f"out of range: {idx.min()}..{idx.max()}")
    for c in classes:
        if not c.is_scalar:
            raise ValueError("per_link_timing classes must be scalar "
                             "LinkTiming instances")
    return LinkTiming(**{
        f: np.asarray([getattr(c, f) for c in classes])[idx]
        for f in _TIMING_FIELDS})


def link_timing_arrays(timing: LinkTiming, n_links: int):
    """Normalise scalar-or-per-link timing to the engine's (L,) vectors.

    Returns ``(t_cycle, t_rev, t_idle_sw)`` int32 arrays of shape (L,) —
    the three costs ``protocol_sim.link_step`` charges — after validating
    shape and the timing contract's invariants.  A scalar ``timing``
    broadcasts; the engines consume only these vectors, so the uniform
    broadcast is bit-exactly the scalar contract.
    """
    def vec(x, name):
        a = np.asarray(x)
        if a.ndim not in (0, 1) or (a.ndim == 1 and a.shape[0] != n_links):
            raise ValueError(f"per-link {name} must be scalar or shape "
                             f"({n_links},), got {a.shape}")
        return np.broadcast_to(a, (n_links,)).astype(np.int64)

    cyc = vec(timing.t_req2req_ns, "t_req2req_ns")
    bidir = vec(timing.t_bidir_ns, "t_bidir_ns")
    idle = vec(timing.t_sw_ns, "t_sw_ns") + vec(timing.t_sw2req_ns,
                                                "t_sw2req_ns")
    if np.any(cyc <= 0):
        raise ValueError("t_req2req_ns must be positive on every link")
    if np.any(bidir < cyc):
        raise ValueError("t_bidir_ns must be >= t_req2req_ns on every link")
    if np.any(idle < 0):
        raise ValueError("idle-switch latency must be >= 0 on every link")
    # the simulator's clocks are int32 ns with the BIG_NS = 2**30 "never
    # released" sentinel; costs at or above it would truncate/wrap after
    # the int32 cast and corrupt silently — refuse them while still on
    # int64 (validated BEFORE the cast)
    big = 1 << 30
    if np.any(bidir >= big) or np.any(idle >= big):
        raise ValueError(
            "per-link timing costs must stay below the int32 BIG_NS "
            f"sentinel ({big} ns); got max cycle {int(bidir.max())} ns, "
            f"max idle switch {int(idle.max())} ns")
    return (cyc.astype(np.int32), (bidir - cyc).astype(np.int32),
            idle.astype(np.int32))


PAPER_TIMING = LinkTiming()

#: The paper §V "sub-words" contract taken to bit-serial (26 beats of one
#: wire): the LVDS-like slow inter-board link class the heterogeneity
#: example and benchmarks mix with the on-board parallel bus.
SERIAL_LVDS_TIMING = PAPER_TIMING.subword(26)

