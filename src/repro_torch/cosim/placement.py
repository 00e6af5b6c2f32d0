"""Placement: neuron populations -> fabric chips, projections -> routes.

The PyTorch port's copy of the reference ``cosim/placement.py``, over
the port's ``Fabric``, ``MulticastPolicy``, ``AddressSpec``,
``MulticastTable`` and ``RoutingTable``; like the reference it is host
numpy code.

A :class:`Population` is a block of LIF neurons that lives together on
one chip (the paper's "core" granularity); a :class:`Projection` is a
synaptic pathway from one population to one or more target populations.
:func:`place` assigns populations to the chips of a
:class:`~repro_torch.core.router.Topology` and compiles every projection
into its transport form:

* pre and post on the SAME chip — a local projection, applied directly
  to the membrane update (never touches the fabric, mirroring the
  paper's on-chip routing fabric);
* post on ONE other chip — a unicast cross route: spikes become AER
  events addressed to that chip (``AddressSpec.pack``);
* posts spread over SEVERAL other chips — a multicast tag: the
  member-chip set goes into a ``MulticastTable`` entry and events carry
  the tagged word (``AddressSpec.pack_multicast``), so an ``in_fabric``
  ``MulticastPolicy`` replicates them on the Steiner tree
  (``router.MulticastTree``) instead of at the source.

The compiled :class:`Placement` is a static artifact: the co-simulation
engine reads its route table every tick, and ``fabric()`` constructs a
``Fabric`` whose address space and multicast table match it by
construction (``device=`` passes through).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..core.fabric import Fabric, MulticastPolicy
from ..core.router import (AddressSpec, MulticastTable, RoutingTable,
                           Topology)

__all__ = ["Population", "Projection", "CrossRoute", "Placement", "place"]

#: LIF kernel lane width: population sizes must tile into (rows, 128).
LANES = 128


class Population(NamedTuple):
    """``size`` LIF neurons placed together on one chip."""
    name: str
    size: int = LANES


class Projection(NamedTuple):
    """Synaptic pathway: every spike of ``pre`` drives current into each
    population in ``posts`` through that projection's dense weight
    matrix (owned by the engine — placement only routes)."""
    pre: int
    posts: tuple
    w_scale: float = 0.3


class CrossRoute(NamedTuple):
    """One compiled inter-chip pathway of a projection.

    ``dest_word`` is what the AER events carry: the packed unicast chip
    word, the packed multicast tag word, or (``addr=None``) the bare
    destination chip id.  ``chips`` is the ordered member-chip tuple the
    word expands to — the delivery-side key mapping a delivered event's
    ``log_dest`` chip back to the post populations fed on that chip.
    """
    proj: int
    src_chip: int
    dest_word: int
    chips: tuple
    tag: int = -1          # multicast tag id, -1 = unicast

    @property
    def fanout(self) -> int:
        return len(self.chips)


@dataclass(frozen=True, eq=False)
class Placement:
    """Populations bound to chips plus the compiled projection routes."""
    topo: Topology
    addr: AddressSpec | None
    populations: tuple
    projections: tuple
    chip_of: np.ndarray            # (P,) int32 chip of each population
    local: tuple                   # ((proj, pre, post), ...) same-chip
    cross: tuple                   # (CrossRoute, ...) proj-major order
    mcast: MulticastTable | None   # tags of the fan-out cross routes
    posts_on: dict = field(default_factory=dict)
    # (proj, chip) -> (post population ids,) — the delivery scatter key

    @property
    def n_pops(self) -> int:
        return len(self.populations)

    @property
    def neurons(self) -> int:
        """Per-population size (uniform — validated in :func:`place`)."""
        return self.populations[0].size

    def pops_on(self, chip: int) -> tuple:
        return tuple(int(p) for p in np.flatnonzero(self.chip_of == chip))

    def fabric(self, **kw) -> Fabric:
        """A :class:`Fabric` matching this placement: same topology,
        same address space, and — when any projection fans out — the
        compiled multicast table under ``in_fabric`` replication.
        Engine / queue / timing policies and ``device`` pass through
        ``kw``."""
        if self.mcast is not None and "mcast" not in kw:
            kw["mcast"] = MulticastPolicy("in_fabric", self.mcast)
        return Fabric(self.topo, addr=self.addr, **kw)


def place(populations, projections, topo: Topology, *,
          chips=None, strategy: str = "round_robin",
          addr: AddressSpec | None = None) -> Placement:
    """Assign populations to chips and compile projections into routes.

    ``chips`` pins the assignment explicitly (one chip id per
    population); otherwise ``strategy`` picks it: ``"round_robin"``
    (population p on chip ``p % n_chips``) or ``"block"`` (contiguous
    runs).  ``addr`` is required as soon as any projection fans out to
    more than one remote chip (the multicast tag needs the word's mcast
    bit); with ``addr=None`` every cross route must be unicast and
    events carry bare chip-id destinations — directly consumable by a
    plain (address-less) :class:`Fabric`, which is what the traffic
    bridge feeds to sweeps.

    Raises ``ValueError`` on anything the fabric would choke on later:
    empty or non-lane-aligned populations, chip ids out of range,
    projection endpoints out of range, unreachable destination chips,
    or address-field overflow (population size vs the AER word's neuron
    field, tag/chip count vs ``addr``'s bit budget).
    """
    populations = tuple(populations)
    projections = tuple(projections)
    if not populations:
        raise ValueError("need at least one population")
    sizes = {p.size for p in populations}
    if len(sizes) != 1:
        raise ValueError(f"population sizes must be uniform (one vmapped "
                         f"LIF state), got {sorted(sizes)}")
    n = populations[0].size
    if n <= 0 or n % LANES:
        raise ValueError(f"population size must be a positive multiple "
                         f"of {LANES} (LIF kernel lanes), got {n}")
    P = len(populations)

    if chips is not None:
        chip_of = np.asarray(list(chips), np.int32)
        if chip_of.shape != (P,):
            raise ValueError(f"chips must give one chip per population "
                             f"({P}), got shape {chip_of.shape}")
    elif strategy == "round_robin":
        chip_of = (np.arange(P) % topo.n_chips).astype(np.int32)
    elif strategy == "block":
        chip_of = (np.arange(P) * topo.n_chips // P).astype(np.int32)
    else:
        raise ValueError(f"unknown placement strategy {strategy!r}")
    if chip_of.min(initial=0) < 0 or \
            chip_of.max(initial=0) >= topo.n_chips:
        raise ValueError(f"population chip id out of range for "
                         f"{topo.n_chips}-chip topology: {chip_of}")
    if addr is not None:
        if topo.n_chips > addr.max_chips:
            raise ValueError(f"{topo.n_chips} chips exceed the address "
                             f"word's {addr.chip_bits}-bit chip field")
        if n > (1 << 16):
            raise ValueError(f"population size {n} exceeds the 16-bit "
                             f"neuron field of the 26-bit AER payload")

    rt = RoutingTable.build(topo)
    local: list = []
    cross: list = []
    members: list = []
    posts_on: dict = {}
    for pi, proj in enumerate(projections):
        if not (0 <= proj.pre < P):
            raise ValueError(f"projection {pi}: pre population "
                             f"{proj.pre} out of range [0, {P})")
        if not proj.posts:
            raise ValueError(f"projection {pi}: empty posts")
        src_chip = int(chip_of[proj.pre])
        remote: dict[int, list] = {}
        for post in proj.posts:
            if not (0 <= post < P):
                raise ValueError(f"projection {pi}: post population "
                                 f"{post} out of range [0, {P})")
            c = int(chip_of[post])
            if c == src_chip:
                local.append((pi, proj.pre, int(post)))
            else:
                if rt.hops[src_chip, c] < 0:
                    raise ValueError(
                        f"projection {pi}: destination chip {c} "
                        f"unreachable from chip {src_chip}")
                remote.setdefault(c, []).append(int(post))
        if not remote:
            continue
        chips_sorted = tuple(sorted(remote))
        for c in chips_sorted:
            posts_on[(pi, c)] = tuple(remote[c])
        if len(chips_sorted) == 1:
            c = chips_sorted[0]
            word = int(addr.pack(c)) if addr is not None else c
            cross.append(CrossRoute(pi, src_chip, word, (c,)))
        else:
            if addr is None:
                raise ValueError(
                    f"projection {pi} fans out to chips {chips_sorted} "
                    f"but the placement has no AddressSpec — multicast "
                    f"tags need the word's mcast bit (pass addr=)")
            tag = len(members)
            if tag >= (1 << addr.chip_bits):
                raise ValueError(f"more multicast tags than the "
                                 f"{addr.chip_bits}-bit tag field holds")
            row = np.zeros(topo.n_chips, bool)
            row[list(chips_sorted)] = True
            members.append(row)
            cross.append(CrossRoute(pi, src_chip,
                                    int(addr.pack_multicast(tag)),
                                    chips_sorted, tag=tag))
    mcast = MulticastTable(np.stack(members)) if members else None
    return Placement(topo=topo, addr=addr, populations=populations,
                     projections=projections, chip_of=chip_of,
                     local=tuple(local), cross=tuple(cross),
                     mcast=mcast, posts_on=posts_on)
