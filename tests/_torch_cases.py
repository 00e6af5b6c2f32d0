"""Seeded numpy inputs for the queue-step kernels, shared by the parity
tests (which also import JAX) and the card-only tests (which must not:
the machine with the card has no JAX).  Every edge case of the kernels'
contract is present: all-``BIG_NS`` rows, fully released rows,
release-time ties, values next to ``BIG_NS``, clocks at or past it, and
lanes whose queue id is >= Q."""

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


