"""Seeded inputs for the port's kernels, shared by the parity tests
(which also import JAX), the card-only tests and ``chip_smoke.py``
(which must not: the machine with the card has no JAX).

The queue-step cases hold every edge case of those kernels' contract:
all-``BIG_NS`` rows, fully released rows, release-time ties, values next
to ``BIG_NS``, clocks at or past it, and lanes whose queue id is >= Q.
The multi-step cases are packed carries from real plans of the
chip_smoke cells (``multistep_cases``), with the helpers that build
them and run the kernel and its plain version over a launch schedule.
The LIF cases (``lif_case``) hold membranes that land exactly on the
threshold and one ulp either side, and inputs where one rounding of
``v * decay + i`` and two roundings disagree; ``fma_f32`` is the exact
single-rounded update they are checked with.  ``COSIM_RING`` and
``SNN_FIG6`` are the configurations of chip_smoke's co-simulation and
SNN phases.  The AER cases (``aer_cases``) hold the encoder's and the
decoder's contract edges: budget overflow, zero, NaN and infinite
thresholds, rows of -0.0, rows with infinities and NaNs (which the
reference spreads over the row), duplicate and out-of-range decode
addresses, bfloat16 values, blocks that are not multiples of 128 or 32,
and, for the card, the full-width and 8-peer shapes of the
``GRANITE_3_2B_LAYER`` gradient tree.  The selective-scan cases
(``scan_cases``) hold the Pallas test's shapes, one-step sequences,
widths that are not multiples of 32, 1 to 32 states (powers of two and
not), steps whose ``exp(dt·A)`` is subnormal or 0, zero inputs, shapes at
the kernel's tile edges and, for the card, falcon-mamba-7b's prefill
shape; ``scan_cotangents`` gives each the seeded dy and dh_final its
gradient is checked with.  Only numpy is imported at
module level; ``repro_torch`` inside the functions that need it."""

from fractions import Fraction

import numpy as np

BIG = 2**30


def scan_case(rng, nq, nc):
    """(q_time, q_dest, t_q) int32 with every edge case present."""
    q = rng.integers(0, 50_000, (nq, nc)).astype(np.int64)
    q[rng.random((nq, nc)) < 0.3] = BIG
    # release-time ties inside a row, values next to the sentinel
    q[:, nc // 2] = q[:, 0]
    edge = np.array([BIG - 1, BIG, BIG + 1, 0, 1], np.int64)
    q[rng.random((nq, nc)) < 0.05] = rng.choice(edge)
    t = rng.integers(0, 60_000, nq).astype(np.int64)
    q[0] = BIG                                   # all-BIG_NS row
    if nq > 1:
        q[1] = rng.integers(0, 100, nc)          # fully released row
        t[1] = 100
    if nq > 2:
        t[2] = BIG                               # clock at the sentinel
    if nq > 3:
        t[3] = BIG + 1                           # past it: BIG releases
    qd = rng.integers(0, 9, (nq, nc))
    return q.astype(np.int32), qd.astype(np.int32), t.astype(np.int32)


#: (Q, C) of the queue scan's card cases: the test shapes, the ring-16
#: full width (32, 768) and the 14x14 mesh's (224, 3072), C = 1 and 3
#: (no 16-byte vector), C = 33 and 6 (not a multiple of 4, so rows
#: start at every 16-byte phase), and (3, 9000), wider than one pass
#: of the kernel's vector loads
STEP_SHAPES = ((4, 7), (2, 5), (16, 96), (32, 768), (224, 3072), (4, 1),
               (4, 3), (5, 33), (6, 6), (3, 9000))
#: (q_time, q_dest) offsets in int32 words from a 16-byte boundary:
#: equal phases take the vector path with a scalar head, unequal ones
#: the scalar path
STEP_OFFSETS = ((1, 1), (2, 2), (3, 3), (0, 1), (1, 0), (2, 3))


def sentinel_scan_case(nq, nc):
    """All-``BIG_NS`` rows (empty queues) and rows of values next to
    ``BIG_NS``, under clocks below, at and past the sentinel, up to
    INT32_MAX."""
    q = np.full((nq, nc), BIG, np.int64)
    q[1::2, ::3] = BIG - 1
    q[1::4, 1::3] = BIG + 1
    clocks = np.array([BIG - 1, BIG, BIG + 1, 2**31 - 1], np.int64)
    t = clocks[(np.arange(nq) // 2) % 4]
    qd = (np.arange(nq * nc).reshape(nq, nc) * 7) % 11
    return q.astype(np.int32), qd.astype(np.int32), t.astype(np.int32)


def offset_tensor(a, device, words, dtype=np.int32):
    """``a`` as a contiguous int32 (or ``dtype``, of 4-byte words) tensor
    whose first element lies ``words`` words past a 16-byte boundary (of
    a fresh, aligned allocation)."""
    import torch
    src = torch.from_numpy(np.ascontiguousarray(a, dtype))
    flat = torch.zeros(a.size + 4, dtype=src.dtype, device=device)
    out = flat[words:words + a.size].view(a.shape)
    out.copy_(src)
    return out


def update_case(rng, nq, nc, k):
    """Pop lanes (one per link, some skipped) and k append lanes per pop
    lane with unique targets disjoint from every pop slot."""
    lp = max(nq // 2, 1)
    half = max(nc // 2, 1)
    pop_q = (2 * np.arange(lp) + rng.integers(0, 2, lp)) % nq
    pop_q[rng.random(lp) < 0.3] = nq             # "no pop on this link"
    pop_slot = rng.integers(0, half, lp)
    la = lp * k
    free = np.array([(r, c) for r in range(nq) for c in range(half, nc)])
    pick = free[rng.choice(len(free), la, replace=False)]
    app_q, app_slot = pick[:, 0].copy(), pick[:, 1]
    app_q[rng.random(la) < 0.3] = rng.choice([nq, nq + 5])
    app_t = rng.choice([0, 7, BIG - 1, BIG, 123_456], la)
    app_dest = rng.integers(0, 9, la)
    app_inj = rng.integers(0, 50_000, la)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return tuple(map(i32, (pop_q, pop_slot, app_q, app_slot, app_t,
                           app_dest, app_inj)))


def planes(rng, nq, nc):
    q, qd, _ = scan_case(rng, nq, nc)
    qi = rng.integers(0, 50_000, (nq, nc)).astype(np.int32)
    return q, qd, qi




# --- traffic of the chip_smoke cells (numpy, seeded) -------------------

def hot_spot_arrays(n_chips, epc, mean_gap_ns, hot_frac, seed, hot_chip=0):
    """``(src, t, dest)`` hot-spot traffic with the reference generator's
    contract: Poisson arrivals per chip, a ``hot_frac`` share of each
    non-hot chip's events sent to ``hot_chip``."""
    rng = np.random.default_rng(seed)
    col = np.repeat(np.arange(n_chips)[:, None], epc, 1)
    times = np.cumsum(rng.exponential(mean_gap_ns, (n_chips, epc))
                      .astype(np.int64), 1)
    d = rng.integers(0, n_chips - 1, col.shape)
    uni = d + (d >= col)
    hot = (rng.random(col.shape) < hot_frac) & (col != hot_chip)
    dest = np.where(hot, hot_chip, uni)
    return col.reshape(-1), times.reshape(-1), dest.reshape(-1)


def anchor_arrays(n):
    """The paper's Fig. 8 cell on a ring-2: n events a side at t = 0."""
    return (np.r_[np.zeros(n), np.ones(n)], np.zeros(2 * n),
            np.r_[np.ones(n), np.zeros(n)])


def mesh_multicast_case(n, seed=8):
    """2x4 mesh in-fabric multicast whose tag-0 tree (from chip 0)
    branches past its source, so K = 2: ``(members, (src, t, dest))``
    with the destinations packed by the default ``AddressSpec``."""
    from repro_torch.core.router import AddressSpec
    members = np.zeros((2, 8), bool)
    members[0, [3, 6]] = True
    members[1, [1, 2, 5, 7]] = True
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 8, n)
    t = np.sort(rng.integers(0, 20_000, n))
    tag = rng.integers(0, 2, n)
    src[tag == 0] = 0
    dest = AddressSpec().pack_multicast(tag)
    order = np.lexsort((t, src))
    return members, (src[order], t[order], dest[order])


def mesh_groups_case(rows, cols, n_groups, n_members, n_events, gap_ns,
                     seed):
    """In-fabric multicast on a ``rows`` x ``cols`` mesh: ``n_groups``
    tags of ``n_members`` random member chips each, ``n_events`` events
    from random sources at uniform times in ``[0, gap_ns)``; returns
    ``(members, (src, t, dest))`` as ``mesh_multicast_case`` does."""
    from repro_torch.core.router import AddressSpec
    n = rows * cols
    rng = np.random.default_rng(seed)
    members = np.zeros((n_groups, n), bool)
    for g in range(n_groups):
        members[g, rng.choice(n, n_members, replace=False)] = True
    src = rng.integers(0, n, n_events)
    t = np.sort(rng.integers(0, gap_ns, n_events))
    tag = rng.integers(0, n_groups, n_events)
    dest = AddressSpec().pack_multicast(tag)
    order = np.lexsort((t, src))
    return members, (src[order], t[order], dest[order])


def spec_of(src, t, dest):
    import torch
    from repro_torch.core.traffic import TrafficSpec
    return TrafficSpec(*(torch.from_numpy(np.asarray(a, np.int32))
                         for a in (src, t, dest)))


# --- the multi-step kernel's cases --------------------------------------

#: steps of every multi-step case: binds mid-chunk at chunk 16 and 128
MS_STEPS = 300


def multistep_cases():
    """``[(name, Fabric keywords (no device), traffic arrays, chunks)]``:
    the chip_smoke cells' specs (anchor, ring-16 credit, 2x4 mesh
    multicast with K = 2) and ring-16 at a binding capacity under each
    flow mode (credit, drop, on/off), each stepped ``MS_STEPS`` times.
    Those three share one shape bucket (``MS_BATCH`` launches them as
    B = 3).  Three more reach the kernel's paths that the 16-link
    fabrics do not: ring-32 (64 queue rows, so a warp scans several)
    with per-link timing and ``max_burst`` 2 under on/off; the 2x4 mesh
    multicast (K = 2) under credit, whose gate skips a route's absent
    second target; and a 14x14 mesh multicast with K = 3 (L = 364 links,
    1,092 lanes, so the appends take 35 chunks of a warp) under credit
    with ``max_burst`` 1.  Four more sit at the edges of the kernel's
    redesign: ring-3 with the near-sentinel shift of
    ``test_torch_fabric.py::test_near_sentinel_switch_count_pinned``
    (clocks a few hundred ns under ``BIG_NS``), the same with every
    link's clock started 20 ns under ``BIG_NS`` (``start_clock``, read
    by ``multistep_operands``), so that clocks pass the sentinel and the
    kernel scans whole rows, and ring-16 hot spots whose ``q_time``
    plane just fits the H100's shared memory (C = 1712: one more event a
    chip would not) and does not (C = 1728).  Ring-40 under credit takes
    two warps (a thread a link) with ``q_time`` resident."""
    from repro_torch.core.fabric import MulticastPolicy, QueuePolicy
    from repro_torch.core.link import (PAPER_TIMING, SERIAL_LVDS_TIMING,
                                       per_link_timing)
    from repro_torch.core.router import (AddressSpec, MulticastTable,
                                         mesh2d_topology, ring_topology)
    members, mcast = mesh_multicast_case(8 * 24)
    wide_members, wide = mesh_groups_case(14, 14, 2, 12, 48, 200, seed=1)
    return [
        ("anchor", dict(topo=ring_topology(2),
                        queues=QueuePolicy(max_burst=1)),
         anchor_arrays(1024), (1, 16, 128)),
        ("ring16_credit", dict(topo=ring_topology(16),
                               queues=QueuePolicy(capacity=64,
                                                  flow="credit")),
         hot_spot_arrays(16, 48, 300.0, 0.65, seed=2), (1, 16, 128)),
        ("ring16_credit_tight", dict(topo=ring_topology(16),
                                     queues=QueuePolicy(capacity=12,
                                                        flow="credit")),
         hot_spot_arrays(16, 48, 300.0, 0.65, seed=5), (16,)),
        ("ring16_drop", dict(topo=ring_topology(16),
                             queues=QueuePolicy(capacity=48, flow="drop")),
         hot_spot_arrays(16, 48, 300.0, 0.65, seed=3), (128,)),
        ("ring16_onoff", dict(topo=ring_topology(16),
                              queues=QueuePolicy(capacity=24,
                                                 flow="onoff")),
         hot_spot_arrays(16, 48, 300.0, 0.65, seed=4), (128,)),
        ("mesh2x4_multicast", dict(topo=mesh2d_topology(2, 4),
                                   addr=AddressSpec(),
                                   mcast=MulticastPolicy(
                                       "in_fabric",
                                       MulticastTable(members))),
         mcast, (1, 16, 128)),
        ("ring32_perlink_burst_onoff",
         dict(topo=ring_topology(32),
              timing=per_link_timing([PAPER_TIMING, SERIAL_LVDS_TIMING],
                                     np.arange(32) % 2),
              queues=QueuePolicy(capacity=16, flow="onoff", max_burst=2)),
         hot_spot_arrays(32, 24, 300.0, 0.65, seed=6), (1, 16, 128)),
        ("mesh2x4_multicast_credit",
         dict(topo=mesh2d_topology(2, 4), addr=AddressSpec(),
              queues=QueuePolicy(capacity=6, flow="credit"),
              mcast=MulticastPolicy("in_fabric", MulticastTable(members))),
         mcast, (16,)),
        ("mesh14x14_multicast_credit",
         dict(topo=mesh2d_topology(14, 14), addr=AddressSpec(),
              queues=QueuePolicy(capacity=2, flow="credit", max_burst=1),
              mcast=MulticastPolicy("in_fabric",
                                    MulticastTable(wide_members))),
         wide, (16, 128)),
        ("ring3_near_sentinel", dict(topo=ring_topology(3)),
         near_sentinel_arrays(), (1, 16, 128)),
        ("ring3_past_sentinel", dict(topo=ring_topology(3),
                                     start_clock=BIG - 20),
         near_sentinel_arrays(), (16, 128)),
        ("ring16_plane_just_fits",
         dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit")),
         hot_spot_arrays(16, 107, 300.0, 0.65, seed=7), (16, 128)),
        ("ring16_plane_spills",
         dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit")),
         hot_spot_arrays(16, 108, 300.0, 0.65, seed=8), (128,)),
        ("ring40_two_warps_credit",
         dict(topo=ring_topology(40),
              queues=QueuePolicy(capacity=4, flow="credit")),
         hot_spot_arrays(40, 12, 50.0, 0.65, seed=9), (16, 128)),
    ]


def near_sentinel_arrays():
    """One event 2 -> 1 on ring-3 at the near-sentinel shift of
    ``test_near_sentinel_switch_count_pinned``: ``BIG_NS`` less seven
    worst-case link costs (41 ns at the paper's timing)."""
    from repro_torch.core.link import PAPER_TIMING
    worst = PAPER_TIMING.t_req2req_ns + max(
        PAPER_TIMING.t_reverse_penalty_ns, PAPER_TIMING.t_idle_switch_ns)
    return [2], [BIG - (3 + 4) * worst], [1]


#: the cases launched together as B = 3 instances
MS_BATCH = ("ring16_credit_tight", "ring16_drop", "ring16_onoff")


def multistep_operands(fab_kw, arrays, steps, device):
    """``(carry, consts, step_fn, plan)`` of a ``steps``-step run of the
    ``kernel="multistep"`` engine on ``device``: the packed reset-time
    carry, the launch's read-only operands, and the plain step over
    ``ref``'s queue step.  A ``start_clock`` entry of ``fab_kw`` (not a
    ``Fabric`` keyword) sets every link's clock in the carry."""
    from repro_torch.core import network as net
    from repro_torch.core.fabric import EngineSpec, Fabric
    from repro_torch.kernels import ref
    fab_kw = dict(fab_kw)
    start_clock = fab_kw.pop("start_clock", None)
    fab = Fabric(**fab_kw, engine=EngineSpec("pallas", kernel="multistep"),
                 device=device)
    plan = fab._plan(spec_of(*arrays), steps)
    (q_time, q_dest, q_inj, sizes, init_tx, links, route_out, route_del,
     route_wt, tc, tv, ti, cap, fc, xon) = fab._get_compiled(
         plan.bucket)._operands(plan)
    L = fab.n_links
    carry = net._pack_slot_state(net._slot_init(
        L, plan.E, q_time, q_dest, q_inj, sizes, init_tx))
    if start_clock is not None:
        carry[3][net._MS_LANES.index("t")] = start_clock
    consts = net._multistep_consts(links, route_out, route_del, route_wt,
                                   tc, tv, ti, cap, fc, xon)
    step_fn = net._multistep_step_fn(
        L, plan.E, plan.C, fab.queues.max_burst, cap, fc, xon,
        ref.fabric_queue_scan, ref.fabric_queue_update)
    return carry, consts, step_fn, plan


def clone(carry):
    return tuple(t.clone() for t in carry)


def run_schedule(launch, carry, steps, chunk):
    """Step ``carry`` through ``ceil(steps / chunk)`` calls of
    ``launch(carry, base, chunk)`` with ``base = 0, chunk, ...``."""
    import torch
    for b in range(0, steps, chunk):
        base = torch.tensor([b], dtype=torch.int32,
                            device=carry[0].device)
        carry = tuple(launch(carry, base, chunk))
    return carry


def carry_err(a, b, n_log):
    """Largest absolute difference of two packed carries, channel for
    channel (int64), the logs compared up to ``n_log`` (beyond is the
    port's scratch column); None when a shape or dtype differs."""
    worst = 0
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return None
        if i == 5:                                   # the log plane
            x, y = x[..., :n_log], y[..., :n_log]
        d = (x.long() - y.long().to(x.device)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


# --- the LIF update's cases ----------------------------------------------

#: (decay, v_th, v_reset) of the LIF cases
LIF_PARAMS = ((0.9, 1.0, 0.0), (0.5, 0.3, 0.0), (1.0, 1.0, -0.2))
#: (rows, lanes) of the CPU parity tests
LIF_SHAPES = ((8, 128), (16, 128), (32, 256), (8, 384))
#: the card's shapes: the tests', the SNN 4x4x256 state, a large one,
#: 4,191 neurons (not a multiple of 4: a scalar tail after the 16-byte
#: vectors) and, as (rows, lanes, words), a view 1 float32 word past a
#: 16-byte boundary (no vectors: the scalar loop over the whole array)
LIF_CARD_SHAPES = LIF_SHAPES + ((32, 128), (65536, 128), (33, 127),
                                (16, 128, 1))

_F32 = np.float32


def f32_round(x: Fraction) -> np.float32:
    """The float32 nearest to the exact rational ``x`` (ties to even)."""
    c = np.float32(float(x))          # within one float32 ulp of x
    best = None
    for y in (np.nextafter(c, _F32(-np.inf)), c,
              np.nextafter(c, _F32(np.inf))):
        if not np.isfinite(y):
            continue
        err = abs(Fraction(float(y)) - x)
        even = int(np.asarray(y).view(np.int32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, y)
    return best[1]


def fma_f32(v, decay, i) -> np.float32:
    """``v * decay + i`` rounded once to float32, exactly (finite
    inputs; ``decay`` is rounded to float32 first)."""
    return f32_round(Fraction(float(v)) * Fraction(float(_F32(decay)))
                     + Fraction(float(i)))


def _near_target(rng, decay, v_th, target, k):
    """``k`` (v, i) pairs whose single-rounded ``v * decay + i`` is
    exactly ``target``: v in a band that keeps ``i`` below the
    threshold, ``i`` stepped an ulp at a time around ``target - v·d``."""
    d = _F32(decay)
    out = []
    while len(out) < k:
        v = _F32(rng.uniform(0.2, 0.8) * v_th / float(d))
        i0 = _F32(float(target) - float(v) * float(d))
        for step in range(-8, 9):
            i = i0
            for _ in range(abs(step)):
                i = np.nextafter(i, _F32(np.inf if step > 0 else -np.inf))
            if fma_f32(v, d, i) == target:
                out.append((v, i))
                break
    return out


def _rounding_splits(rng, decay, v_th, k, flip):
    """``k`` (v, i) pairs where one rounding and two roundings of
    ``v * decay + i`` disagree; with ``flip`` also on which side of
    ``v_th`` they land (the spike flips)."""
    d = _F32(decay)
    out = []
    while len(out) < k:
        if flip:
            v = _F32(rng.uniform(0.2, 0.8) * v_th / float(d))
            i0 = _F32(float(v_th) - float(v) * float(d))
            cand = [i0]
            for _ in range(16):
                cand.append(np.nextafter(cand[-1], _F32(np.inf)))
                cand.insert(0, np.nextafter(cand[0], _F32(-np.inf)))
        else:
            v = _F32(rng.uniform(-0.5, 1.2))
            cand = [_F32(rng.uniform(-0.2, 0.6))]
        for i in cand:
            one = fma_f32(v, d, i)
            two = _F32(_F32(v * d) + i)
            if one != two and (not flip
                               or (one >= _F32(v_th)) != (two >= _F32(v_th))):
                out.append((v, i))
                break
    return out


def lif_case(seed, shape, decay, v_th, v_reset):
    """Seeded float32 ``(v, i_syn)`` of ``shape``: random membranes and
    currents, with edge elements at the front — updates landing exactly
    on ``v_th`` and one ulp either side, ±inf membranes, and (for a
    decay whose products round) inputs where one and two roundings
    disagree, some of them across the threshold.  ``v_reset`` does not
    shape the inputs; it is in the signature so a case names all of the
    update's parameters."""
    del v_reset
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.5, 1.2, shape).astype(_F32)
    i = rng.uniform(-0.2, 0.6, shape).astype(_F32)
    th = _F32(v_th)
    pairs = []
    for target in (th, np.nextafter(th, _F32(-np.inf)),
                   np.nextafter(th, _F32(np.inf))):
        pairs += _near_target(rng, decay, v_th, target, 6)
    pairs += [(_F32(np.inf), _F32(0.25)), (_F32(-np.inf), _F32(0.25))]
    if np.frexp(np.float64(_F32(decay)))[0] != 0.5:
        # decay is no power of two, so v * decay can round: one and two
        # roundings of the update can differ
        pairs += _rounding_splits(rng, decay, v_th, 12, flip=False)
        pairs += _rounding_splits(rng, decay, v_th, 6, flip=True)
    vf, i_f = v.reshape(-1), i.reshape(-1)
    for k, (a, b) in enumerate(pairs):
        vf[k], i_f[k] = a, b
    return v, i


def lif_cases(shapes=LIF_SHAPES, params=LIF_PARAMS):
    """``[(name, v, i_syn, decay, v_th, v_reset)]`` over ``shapes`` x
    ``params``, each seeded by its position.  A shape's third entry, the
    card's storage offset in words (``lif_on_card``), is named in the
    case and does not change its values."""
    out = []
    for si, shape in enumerate(shapes):
        at = f"_at{shape[2]}" if len(shape) > 2 else ""
        for pi, (d, th, rst) in enumerate(params):
            v, i = lif_case(1000 + 10 * si + pi, shape[:2], d, th, rst)
            out.append((f"{shape[0]}x{shape[1]}{at}_d{d}_th{th}_r{rst}", v,
                        i, d, th, rst))
    return out


def lif_on_card(a, device, shape):
    """``a`` as a contiguous float32 tensor on ``device`` whose first
    element lies ``shape[2]`` words (0 when ``shape`` has two entries)
    past a 16-byte boundary."""
    return offset_tensor(a, device, shape[2] if len(shape) > 2 else 0,
                         np.float32)


def lif_exact(v, i, decay, v_th, v_reset):
    """The update of one element, exactly: ``(v_next, spike)`` float32
    from the single-rounded :func:`fma_f32`."""
    v2 = fma_f32(v, decay, i)
    spike = bool(v2 >= _F32(v_th))
    return (_F32(v_reset) if spike else v2), _F32(spike)


def lif_double_roundings(v, i, decay, v_th, v_reset, got, plain):
    """Elements where the kernel's ``got = (v_next, spikes)`` and the
    plain version's ``plain`` differ, each checked against
    :func:`lif_exact`.  Returns ``(n_confirmed, n_unexplained)``: a
    confirmed element is one where ``got`` is exact and ``plain`` is not
    (the float64 route rounded twice)."""
    def bits(a):
        return np.ascontiguousarray(a, _F32).reshape(-1).view(np.int32)

    diff = np.flatnonzero((bits(got[0]) != bits(plain[0]))
                          | (bits(got[1]) != bits(plain[1])))
    vf, i_f = v.reshape(-1), i.reshape(-1)
    ok = 0
    for k in diff:
        want = lif_exact(vf[k], i_f[k], decay, v_th, v_reset)
        g = (got[0].reshape(-1)[k], got[1].reshape(-1)[k])
        p = (plain[0].reshape(-1)[k], plain[1].reshape(-1)[k])
        if g == want and p != want:
            ok += 1
    return ok, len(diff) - ok


# --- the MoE combine -----------------------------------------------------

#: (E, K) of the combine's cases: moonshot's top-6 of 64, mixtral's and
#: jamba's top-2 of 8
COMBINE_ROUTINGS = ((64, 6), (8, 2))


def combine_case(seed, B, S, E, K, D, capacity):
    """Seeded inputs of ``moe._combine``: ``(contrib (B, E, C, D)
    float32, choice, pos (B, S, K) int64, valid (B, S, K) bool, slot_tok
    (B, E, C) int32)``.  Each token picks K distinct experts in a random
    order (not ascending), the first half of every row's tokens put
    expert 0 first so that it overflows its C slots (those tokens keep
    fewer than K), and positions follow the dispatch's running count over
    the (S·K) order.  Slots no kept choice fills hold zeros (their gate
    is 0); ``slot_tok`` is 0 there, as in the reference's slot table.
    Row 0's tokens 0 and 1 carry the terms 1, 2^-8 and -1 in ascending
    expert order (-1, 1, 2^-8 for token 1; zeros after them), whose
    bfloat16 sum depends on the order and on rounding after each add."""
    rng = np.random.default_rng(seed)
    choice = np.stack([np.stack([rng.permutation(E)[:K] for _ in range(S)])
                       for _ in range(B)])
    for b in range(B):
        for s in range(S // 2):
            if 0 not in choice[b, s]:
                choice[b, s, 0] = 0
            else:
                k = int(np.flatnonzero(choice[b, s] == 0)[0])
                choice[b, s, [0, k]] = choice[b, s, [k, 0]]
    pos = np.zeros((B, S, K), np.int64)
    for b in range(B):
        count = np.zeros(E, np.int64)
        for s in range(S):
            for k in range(K):
                pos[b, s, k] = count[choice[b, s, k]]
                count[choice[b, s, k]] += 1
    valid = pos < capacity
    contrib = np.zeros((B, E, capacity, D), np.float32)
    slot_tok = np.zeros((B, E, capacity), np.int32)
    b_i, s_i, k_i = np.nonzero(valid)
    e_i, c_i = choice[b_i, s_i, k_i], pos[b_i, s_i, k_i]
    contrib[b_i, e_i, c_i] = rng.standard_normal((len(b_i), D))
    slot_tok[b_i, e_i, c_i] = s_i
    if K >= 3:
        for s, terms in ((0, (1.0, 2.0 ** -8, -1.0)),
                         (1, (-1.0, 1.0, 2.0 ** -8)))[:S]:
            ks = [k for k in np.argsort(choice[0, s]) if valid[0, s, k]]
            for j, k in enumerate(ks):
                contrib[0, choice[0, s, k], pos[0, s, k]] = \
                    terms[j] if j < 3 else 0.0
    return contrib, choice, pos, valid, slot_tok


# --- the co-simulation and SNN phases ------------------------------------

#: the closed-loop co-simulation cell: ``COSIM_RING`` of
#: benchmarks/fabric_sweep.py:412 (the reference's key 9 becomes the
#: generator seed 9): a recurrent SNN on ring-16, 128 neurons a chip,
#: credit flow at capacity 96, input rate 0.06, 24 ticks
COSIM_RING = dict(n_chips=16, seed=9, capacity=96, input_rate=0.06,
                  ticks=24)
#: the Fig. 6 chip array of benchmarks/paper_benches.py:136-139: a 4x4
#: grid of 256-neuron chips, 50 ticks (key 0 -> seed 0)
SNN_FIG6 = dict(grid=(4, 4), neurons=256, ticks=50, seed=0)


# --- the AER payload path ------------------------------------------------

#: the shapes of tests/test_kernels.py's encoder sweep, (nb, block,
#: budget), and a block that is no multiple of 32 and spans five tiles;
#: then blocks that are no multiple of 4 (float32) or 8 (bfloat16), so
#: that the encoder loads them one entry at a time, and a block of three
#: 1,024-entry tiles with room for every edge row of ``aer_encode_case``
#: and ``aer_decode_case`` and a budget that is no multiple of 32
AER_SHAPES = ((4, 256, 32), (8, 1024, 128), (16, 512, 64), (4, 2048, 256),
              (2, 128, 128), (12, 384, 48), (3, 4999, 100), (5, 1023, 128),
              (6, 1020, 64), (12, 3072, 150))
#: card-only shapes: one granite-3.0-2b MLP weight (2048 x 8192) in
#: 1024-blocks at the default budget; a block whose decode row fills the
#: 48 KB default of shared memory, so that only with the kernel's static
#: scratch does it need the opt-in; and the largest block (16-bit
#: addresses), whose float32 decode row does not fit shared memory
AER_CARD_SHAPES = ((16384, 1024, 128), (4, 12288, 128), (2, 65536, 64))
#: the decoder after an 8-rank all-gather of that weight's slots
AER_PEERS = 8

#: the gradient tree of one granite-3.0-2b decoder layer
#: (src/repro/configs/granite_3_2b.py: d_model 2048, 32 heads of 64, 8
#: kv heads, d_ff 8192; names as src/repro/models/transformer.py:60-70
#: and layers.py:261-267,402-406 build them): 60.8 M float32 entries
GRANITE_3_2B_LAYER = {
    "ln1": {"scale": (2048,)},
    "attn": {"wq": {"w": (2048, 2048)}, "wk": {"w": (2048, 512)},
             "wv": {"w": (2048, 512)}, "wo": {"w": (2048, 2048)}},
    "ln2": {"scale": (2048,)},
    "ffn": {"wg": {"w": (2048, 8192)}, "wi": {"w": (2048, 8192)},
            "wo": {"w": (8192, 2048)}},
}


def bf16_round(a) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    still float32, so both frameworks' casts to bfloat16 are exact.
    NaN stays NaN."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    out = r.view(np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), out).astype(np.float32)


def _quantile_tau(x, keep):
    """Per-row thresholds that keep about ``keep`` of each row's finite
    magnitudes."""
    a = np.where(np.isfinite(x), np.abs(x), np.nan)
    return np.nanquantile(a, 1 - keep, axis=1).astype(np.float32)


def aer_encode_case(seed, nb, block, budget, dtype="float32"):
    """``(x, tau)`` float32 (bfloat16 values when ``dtype`` says so) with
    the encoder's edge rows: row 0 over budget; row 1 an inf and a -inf;
    row 2 a NaN; row 3 half zeros and -0.0 under a zero threshold
    (overflow); row 4 one inf; row 5 a NaN threshold; row 6 all -0.0
    under a zero threshold; row 7 an infinite threshold; row 8 a run of
    budget + 3 selected entries whose budget-th falls on the second entry
    of a 16-byte vector (float32 and bfloat16); row 9 exactly ``budget``
    selected; row 10 over budget with a NaN as its last entry and row 11
    with an inf there, each past the budget and in no slot."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, block)).astype(np.float32)
    keep = np.where(np.arange(nb) % 3 == 0,
                    min(1.0, 1.5 * budget / block), 0.05)
    rows = {}
    if nb > 1:
        x[1, 5 % block], x[1, 9 % block] = np.inf, -np.inf
    if nb > 2:
        x[2, 3 % block] = np.nan
    if nb > 3:
        x[3, ::2] = 0.0
        x[3, 1::4] = -0.0
        rows[3] = 0.0
    if nb > 4:
        x[4, 7 % block] = np.inf
    if nb > 5:
        rows[5] = np.nan
    if nb > 6:
        x[6] = -0.0
        rows[6] = 0.0
    if nb > 7:
        rows[7] = np.inf
    def big(r):   # the row's own draws moved to [1.5, 2.5); the rest
        b = np.float32(1.5) + np.abs(x[r]) % np.float32(1.0)
        x[r] %= np.float32(0.5)   # to [0, 0.5), under a threshold of 1
        rows[r] = 1.0
        return b
    if nb > 8 and block >= budget + 11:
        # selected entries s .. s + budget + 2; the budget-th at s +
        # budget - 1, which is 1 mod 8: inside a vector of 4 or of 8
        s0 = (2 - budget) % 8
        x[8, s0:s0 + budget + 3] = big(8)[s0:s0 + budget + 3]
    if nb > 9:
        pick = rng.choice(block, budget, replace=False)
        x[9, pick] = -big(9)[pick]
    for r, bad in ((10, np.nan), (11, np.inf)):
        if nb > r:
            x[r, -1] = bad
            keep[r] = min(1.0, 2.0 * budget / block)
    tau = np.empty(nb, np.float32)
    for r in range(nb):
        tau[r] = rows.get(r, _quantile_tau(x[r:r + 1], keep[r])[0])
    if dtype == "bfloat16":
        x, tau = bf16_round(x), bf16_round(tau)
    return x, tau


def aer_decode_case(seed, nb, budget, block, dtype="float32"):
    """``(idx, val)``: (nb, budget) int32 addresses drawn from a narrow
    range, so rows repeat addresses, with void slots (-1) and addresses
    past the block; values float32 (bfloat16 values when ``dtype`` says
    so).  Edge rows: row 1 an inf at a repeated address; row 2 a NaN in a
    void slot; row 3 an inf and a -inf at one address; row 4 one inf at
    an address of its own; row 5 a NaN at an address past the block; row
    6 one address in slots 31 and 32, either side of a 32-slot chunk's
    edge; row 7 distinct addresses (every group of a chunk one slot) and
    a void slot in every fifth; row 8 addresses that rise slot by slot
    with repeats (slots 0 to 2 share one), voids after them; row 9
    strictly rising addresses, voids after them, as the encoder writes
    its slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, min(block, max(4, budget // 2)) + 2,
                       (nb, budget)).astype(np.int32)
    idx[idx >= min(block, max(4, budget // 2))] = block   # past the block
    val = rng.standard_normal((nb, budget)).astype(np.float32)
    if nb > 1:
        idx[1, :3] = 2
        val[1, 1] = np.inf
    if nb > 2:
        idx[2, 0] = -1
        val[2, 0] = np.nan
    if nb > 3:
        idx[3, :2] = 1
        val[3, 0], val[3, 1] = np.inf, -np.inf
    if nb > 4:
        idx[4, 0] = block - 1
        idx[4, 1:][idx[4, 1:] == block - 1] = -1
        val[4, 0] = np.inf
    if nb > 5:
        idx[5, 0] = block + 7
        val[5, 0] = np.nan
    if nb > 6 and budget > 32:
        idx[6, 31] = idx[6, 32] = block // 2
    if nb > 7 and budget <= block:
        idx[7] = rng.permutation(block)[:budget]
        idx[7, ::5] = -1
    for r in (8, 9):
        if nb > r:
            n = budget - budget // 4
            rise = np.sort(rng.choice(block, n, replace=r == 8))
            if r == 8:
                rise[1] = rise[2] = rise[0]
            idx[r] = -1
            idx[r, :n] = rise
    if dtype == "bfloat16":
        val = bf16_round(val)
    return idx, val


def aer_peer_case(seed, peers=AER_PEERS, nb=16384, budget=128,
                  block=1024):
    """``(idx, val)`` as ``peers`` all-gathered encoder outputs of an
    (nb, block) tensor: each row's addresses increasing, distinct, and
    void (-1) past the row's count."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, 2 * block // budget, (peers * nb, budget))
    idx = np.cumsum(gaps, axis=1) - 1
    idx[idx >= block] = -1
    val = rng.standard_normal((peers * nb, budget)).astype(np.float32)
    return idx.astype(np.int32), val


def aer_specs(card=False):
    """``(name, kind, nb, block, budget, dtype)`` of every AER case,
    without its arrays: ``kind`` is "encode", "decode" or "peers" (the
    8-peer decode); ``card=True`` adds the card-only shapes."""
    shapes = AER_SHAPES + (AER_CARD_SHAPES if card else ())
    out = []
    for dtype in ("float32", "bfloat16"):
        for nb, block, budget in shapes:
            if nb * block > 2**22 and dtype != "float32":
                continue
            name = f"{dtype}-{nb}x{block}-b{budget}"
            out.append((f"enc-{name}", "encode", nb, block, budget, dtype))
            if nb * block <= 2**22:
                out.append((f"dec-{name}", "decode", nb, block, budget,
                            dtype))
    if card:
        out.append((f"dec-peers{AER_PEERS}-float32", "peers",
                    AER_PEERS * 16384, 1024, 128, "float32"))
    return out


def aer_arrays(spec):
    """The seeded arrays of one ``aer_specs`` entry: ``(x, tau, budget)``
    for "encode", ``(idx, val, block)`` for the decodes."""
    _, kind, nb, block, budget, dtype = spec
    seed = nb * block + budget + (dtype == "bfloat16")
    if kind == "encode":
        return (*aer_encode_case(seed, nb, block, budget, dtype), budget)
    if kind == "decode":
        return (*aer_decode_case(seed, nb, budget, block, dtype), block)
    return (*aer_peer_case(2014, AER_PEERS, nb // AER_PEERS, budget,
                           block), block)


def aer_cases(card=False):
    """``(name, kind, a, b, n, dtype)``: every ``aer_specs`` entry with its
    arrays (numpy float32 / int32; ``dtype`` is the value dtype to run
    them in)."""
    return [(spec[0], spec[1], *aer_arrays(spec), spec[5])
            for spec in aer_specs(card)]


#: every route of the encoder (B5) and decoder (B6) with a case that
#: takes it: ``(name, kind, nb, block, budget, dtype, offset, route)``;
#: ``offset`` puts x that many entries past a 16-byte boundary (a
#: contiguous view with an odd storage offset), which only the scalar
#: routes take
AER_ROUTE_CASES = (
    ("enc-vector", "encode", 16, 1024, 128, "float32", 0, "vector"),
    ("enc-vector-bf16", "encode", 16, 1024, 128, "bfloat16", 0, "vector"),
    ("enc-vector-tiles", "encode", 12, 3072, 150, "float32", 0,
     "vector_tiles"),
    ("enc-scalar-block", "encode", 5, 1023, 128, "float32", 0, "scalar"),
    ("enc-scalar-block-bf16", "encode", 6, 1020, 64, "bfloat16", 0,
     "scalar"),
    ("enc-scalar-offset", "encode", 16, 1024, 128, "float32", 1, "scalar"),
    ("enc-scalar-offset-bf16", "encode", 16, 1024, 128, "bfloat16", 3,
     "scalar"),
    ("enc-scalar-tiles", "encode", 3, 4999, 100, "float32", 0,
     "scalar_tiles"),
    ("enc-scalar-tiles-offset", "encode", 12, 3072, 150, "bfloat16", 5,
     "scalar_tiles"),
    ("dec-warp", "decode", 16, 1024, 128, "float32", 0, "warp"),
    ("dec-warp-bf16", "decode", 6, 1020, 64, "bfloat16", 0, "warp"),
    ("dec-warp-optin", "decode", 4, 12288, 128, "float32", 0,
     "warp_optin"),
    ("dec-global", "decode", 2, 65536, 64, "float32", 0, "global"),
    ("dec-global-bf16", "decode", 2, 65536, 64, "bfloat16", 0, "global"),
)


def aer_route_arrays(case):
    """The seeded arrays of one ``AER_ROUTE_CASES`` entry, as
    ``aer_arrays`` gives them for the same shape."""
    name, kind, nb, block, budget, dtype, _, _ = case
    return aer_arrays((name, kind, nb, block, budget, dtype))


def aer_offset_copy(a, dtype, offset, device):
    """``a`` (numpy float32) as a contiguous tensor of ``dtype`` whose
    first element lies ``offset`` elements past the start of a fresh
    (16-byte aligned) allocation."""
    import torch
    flat = torch.zeros(a.size + offset, dtype=dtype, device=device)
    out = flat[offset:].view(a.shape)
    out.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    return out


def aer_mismatches(want, got) -> int:
    """Elements where two numpy arrays differ bit for bit: floats are
    compared as float32 bit patterns (bfloat16 widens exactly), except
    that any NaN equals any NaN."""
    w, g = np.asarray(want), np.asarray(got)
    if w.shape != g.shape:
        raise ValueError(f"shapes differ: {w.shape} and {g.shape}")
    if w.dtype.kind != "f":
        return int((w != g).sum())
    w, g = w.astype(np.float32), g.astype(np.float32)
    nw, ng = np.isnan(w), np.isnan(g)
    return int(((nw != ng) | (~nw & (w.view(np.int32) != g.view(np.int32))))
               .sum())


def clear_of_tau(tiles, tau) -> bool:
    """No entry of the (nb, block) tensor ``tiles`` lies within one
    float32 ulp of its row's threshold ``tau`` (either side, or on it),
    so a one-ulp difference in tau cannot change what is selected."""
    import torch
    a = tiles.float().abs()
    t = tau.float()[:, None]
    inf = torch.full_like(t, float("inf"))
    near = (a == t) | (a == torch.nextafter(t, -inf)) | \
        (a == torch.nextafter(t, inf))
    return not bool(near.any())


# --- the selective scan's cases (B7) --------------------------------------

#: (B, S, d_in, N) of the reference's tests/test_kernels_scan.py
SCAN_SHAPES = ((1, 32, 16, 4), (2, 64, 32, 8), (2, 48, 8, 16),
               (1, 16, 128, 4))
#: falcon-mamba-7b's prefill scan on the serve path: 4 prompts of 2048
#: tokens, d_inner 8192, d_state 16
SCAN_SERVE_SHAPE = (4, 2048, 8192, 16)
#: jamba-v0.1-52b's prefill scan on its serve path: 2 prompts of 4096
#: tokens, d_inner 2 * 4096 = 8192, d_state 16 (its Mamba layers draw A
#: and dt as falcon-mamba-7b's do)
SCAN_JAMBA_SHAPE = (2, 4096, 8192, 16)
#: (B, S, d_in, N) at the kernel's tile edges, small enough for the CPU:
#: S one 32-step tile +- 1, d_in a block's channels +- 1 (64 at two
#: threads a channel, 128 at N = 1), N in {1, 17, 32}
SCAN_EDGE_SHAPES = ((2, 31, 127, 1), (2, 33, 65, 17), (1, 33, 129, 32))
#: the same edges over many sequences (a tall grid), on the card
SCAN_CARD_EDGE_SHAPES = ((64, 33, 63, 17), (66, 31, 129, 32))
#: |kernel - plain| <= tol + tol·|plain| for y and h_final: the
#: reference's own tolerance at the test shapes
#: (tests/test_kernels_scan.py:33), ten times that over the serve
#: shapes' 2048 and 4096 steps (PERF.md says why)
SCAN_TOL = 1e-5
SCAN_SERVE_TOL = 1e-4
#: |kernel - plain| <= tol · max|plain| for each gradient of the scan's
#: backward (float32 sums over d_in, N and B·S in another order: the CPU
#: plain version meets the reference's pullback within ~5e-7 of the max
#: on the CPU cases), ten times that over the serve shapes' 2048 and
#: 4096 steps
SCAN_BWD_TOL = 1e-5
SCAN_BWD_SERVE_TOL = 1e-4
#: falcon-mamba-7b's training scan on the card (4 sequences of 2048
#: tokens, d_inner 8192, d_state 16): the serve shape
SCAN_TRAIN_SHAPE = SCAN_SERVE_SHAPE


def _softplus(v):
    return np.logaddexp(v, np.float32(0)).astype(np.float32)


def selective_scan_case(seed, bsz, seq, d_in, n, *, falcon=False,
                        underflow=False, zero_x=False):
    """``(x, dt, b, c, a)`` float32.  By default the distributions of the
    reference test's ``make_inputs`` (x, B, C normal, dt =
    softplus(normal - 1), A = -exp(0.5·normal)); ``falcon``: the model's
    A = -exp(log(1..N)) and dt = softplus(0.5·normal + dt_bias) with
    softplus(dt_bias) in [1e-3, 1e-1], as ``mamba_init`` draws it.
    ``underflow`` (with the model's A): every third step of every other
    channel has dt in [100, 300], so exp(dt·A) is subnormal or 0, with x
    divided by dt there so that dt·x stays O(1).  ``zero_x``: every
    fourth step, and the second sequence, are all zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, seq, d_in), np.float32)
    if falcon or underflow:
        a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                             (d_in, n)).copy()
        u = rng.random(d_in)
        dt0 = np.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
        bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
        dt = _softplus(np.float32(0.5)
                       * rng.standard_normal((bsz, seq, d_in), np.float32)
                       + bias)
    else:
        dt = _softplus(rng.standard_normal((bsz, seq, d_in), np.float32)
                       - np.float32(1.0))
        a = -np.exp(np.float32(0.5)
                    * rng.standard_normal((d_in, n), np.float32))
    b = rng.standard_normal((bsz, seq, n), np.float32)
    c = rng.standard_normal((bsz, seq, n), np.float32)
    if underflow:
        at = (slice(None), slice(0, None, 3), slice(0, None, 2))
        dt[at] = rng.uniform(100.0, 300.0, dt[at].shape)
        x[at] /= dt[at]
    if zero_x:
        x[:, ::4] = 0.0
        x[1:2] = 0.0
    return tuple(np.ascontiguousarray(v, np.float32)
                 for v in (x, dt, b, c, a))


def scan_specs(card=False):
    """``(name, (B, S, d_in, N), options, tol)`` of every selective-scan
    case; ``card=True`` adds the card-only shapes."""
    specs = [(f"test-{b}x{s}x{d}x{n}", (b, s, d, n), {}, SCAN_TOL)
             for b, s, d, n in SCAN_SHAPES]
    specs += [
        ("one-step", (2, 1, 48, 16), {}, SCAN_TOL),
        ("d40-N1", (2, 24, 40, 1), {}, SCAN_TOL),
        ("d33-N5", (3, 20, 33, 5), {}, SCAN_TOL),
        ("d24-N32", (1, 40, 24, 32), {}, SCAN_TOL),
        ("d72-N12", (2, 17, 72, 12), {}, SCAN_TOL),
        ("underflow-N16", (2, 64, 40, 16), {"underflow": True}, SCAN_TOL),
        ("zero-x-N4", (2, 32, 24, 4), {"zero_x": True}, SCAN_TOL),
    ]
    # the kernel's tile edges (SCAN_EDGE_SHAPES)
    specs += [(f"edge-S{s}-d{d}-N{n}", (b, s, d, n), {}, SCAN_TOL)
              for b, s, d, n in SCAN_EDGE_SHAPES]
    if card:
        specs += [(f"edge-S{s}-d{d}-N{n}-B{b}", (b, s, d, n), {}, SCAN_TOL)
                  for b, s, d, n in SCAN_CARD_EDGE_SHAPES]
        specs += [
            ("falcon-1x256x1000", (1, 256, 1000, 16), {"falcon": True},
             SCAN_TOL),
            ("falcon-serve", SCAN_SERVE_SHAPE, {"falcon": True},
             SCAN_SERVE_TOL),
            ("jamba-serve", SCAN_JAMBA_SHAPE, {"falcon": True},
             SCAN_SERVE_TOL),
        ]
    return specs


def scan_arrays(spec):
    """The seeded ``(x, dt, b, c, a)`` of one ``scan_specs`` entry."""
    _, (bsz, seq, d_in, n), opts, _ = spec
    return selective_scan_case(bsz * 1000003 + seq * 1009 + d_in * 31 + n,
                               bsz, seq, d_in, n, **opts)


def scan_cases(card=False):
    """``(name, x, dt, b, c, a, tol)``: every ``scan_specs`` entry with
    its arrays."""
    return [(spec[0], *scan_arrays(spec), spec[3])
            for spec in scan_specs(card)]


def scan_errors(want, got):
    """``(max abs error, max relative error, worst |got - want| /
    (1 + |want|))`` over the elements of two float arrays; the last is
    the one a tolerance ``tol`` bounds as ``|d| <= tol + tol·|want|``."""
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    d = np.abs(g - w)
    rel = d / np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    return (float(d.max(initial=0.0)), float(rel.max(initial=0.0)),
            float((d / (1.0 + np.abs(w))).max(initial=0.0)))


def scan_cotangents(spec, dh: bool):
    """The seeded ``(dy (B, S, d_in), dh_final (B, d_in, N))`` float32 of
    one ``scan_specs`` entry; ``dh_final`` is zeros unless ``dh``."""
    _, (bsz, seq, d_in, n), _, _ = spec
    rng = np.random.default_rng(bsz * 7 + seq * 5 + d_in * 3 + n)
    dy = rng.standard_normal((bsz, seq, d_in), np.float32)
    dhf = (rng.standard_normal((bsz, d_in, n), np.float32) if dh
           else np.zeros((bsz, d_in, n), np.float32))
    return dy, dhf


def scan_bwd_tol(spec) -> float:
    """The backward's tolerance of one ``scan_specs`` entry."""
    return SCAN_BWD_SERVE_TOL if spec[3] == SCAN_SERVE_TOL else SCAN_BWD_TOL
