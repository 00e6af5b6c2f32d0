"""Seeded inputs for the port's kernels, shared by the parity tests
(which also import JAX), the card-only tests and ``chip_smoke.py``
(which must not: the machine with the card has no JAX).

The queue-step cases hold every edge case of those kernels' contract:
all-``BIG_NS`` rows, fully released rows, release-time ties, values next
to ``BIG_NS``, clocks at or past it, and lanes whose queue id is >= Q.
The multi-step cases are packed carries from real plans of the
chip_smoke cells (``multistep_cases``), with the helpers that build
them and run the kernel and its plain version over a launch schedule.
Only numpy is imported at module level; ``repro_torch`` inside the
functions that need it."""

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
