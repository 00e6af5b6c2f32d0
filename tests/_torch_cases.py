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
SNN phases.  Only numpy is imported at module level; ``repro_torch``
inside the functions that need it."""

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
    1,092 lanes, so threads stride over lanes) under credit with
    ``max_burst`` 1."""
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
    ]


#: the cases launched together as B = 3 instances
MS_BATCH = ("ring16_credit_tight", "ring16_drop", "ring16_onoff")


def multistep_operands(fab_kw, arrays, steps, device):
    """``(carry, consts, step_fn, plan)`` of a ``steps``-step run of the
    ``kernel="multistep"`` engine on ``device``: the packed reset-time
    carry, the launch's read-only operands, and the plain step over
    ``ref``'s queue step."""
    from repro_torch.core import network as net
    from repro_torch.core.fabric import EngineSpec, Fabric
    from repro_torch.kernels import ref
    fab = Fabric(**fab_kw, engine=EngineSpec("pallas", kernel="multistep"),
                 device=device)
    plan = fab._plan(spec_of(*arrays), steps)
    (q_time, q_dest, q_inj, sizes, init_tx, links, route_out, route_del,
     route_wt, tc, tv, ti, cap, fc, xon) = fab._get_compiled(
         plan.bucket)._operands(plan)
    L = fab.n_links
    carry = net._pack_slot_state(net._slot_init(
        L, plan.E, q_time, q_dest, q_inj, sizes, init_tx))
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
#: the card's shapes: the tests', the SNN 4x4x256 state and a large one
LIF_CARD_SHAPES = LIF_SHAPES + ((32, 128), (65536, 128))

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
    ``params``, each seeded by its position."""
    out = []
    for si, shape in enumerate(shapes):
        for pi, (d, th, rst) in enumerate(params):
            v, i = lif_case(1000 + 10 * si + pi, shape, d, th, rst)
            out.append((f"{shape[0]}x{shape[1]}_d{d}_th{th}_r{rst}", v, i,
                        d, th, rst))
    return out


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
