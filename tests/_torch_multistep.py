"""Shared by the multi-step tests that need no reference
(``test_torch_fabric_multistep*.py``): what each of the card's
multi-step cases must reach in its plain run, and the windowed scan the
kernel relies on, checked after every step of a case's plain run.  The
cases' plain runs are the slowest CPU tests of the port (up to ~150 s a
case on one worker), so the files split the cases between them
(``SPLIT``): each file stays under ~400 s on one worker.

Imported as ``_torch_multistep`` (the tests directory is on the path).
"""

import torch

from repro_torch.core import network as tnet
from repro_torch.kernels import fabric_queue as tfq
from repro_torch.kernels import ref as tref

from _torch_cases import (BIG, MS_STEPS, clone, multistep_cases,
                          multistep_operands, run_schedule)

CPU = "cpu"

#: which file runs which case's plain-run tests: the mesh case in
#: ``_mesh.py``, the two widest rings' column checks in ``_wide.py``
MESH = ("mesh14x14_multicast_credit",)
WIDE = ("ring16_plane_just_fits", "ring40_two_warps_credit")

#: what the card's multi-step cases must reach in their MS_STEPS-step
#: plain run (chip_smoke checks the same on the card): the kernel's
#: paths that 16-link fabrics leave out, its shared-memory tiers on an
#: H100 (``fabric_queue.MS_TIERS``) and the clocks near the sentinel
CASE_CLAIMS = {
    "ring32_perlink_burst_onoff": dict(L=32, K=1, max_burst=2, tier=2),
    "mesh2x4_multicast_credit": dict(L=10, K=2, max_burst=0, tier=4),
    "mesh14x14_multicast_credit": dict(L=364, K=3, max_burst=1, tier=0),
    "ring3_near_sentinel": dict(L=3, K=1, max_burst=0, tier=4,
                                clocks="near"),
    "ring3_past_sentinel": dict(L=3, K=1, max_burst=0, tier=4,
                                clocks="past"),
    "ring16_plane_just_fits": dict(L=16, K=1, max_burst=0, tier=2),
    "ring16_plane_spills": dict(L=16, K=1, max_burst=0, tier=1),
    "ring40_two_warps_credit": dict(L=40, K=1, max_burst=0, tier=2),
}


def plain_steps(carry, consts, step_fn, steps=MS_STEPS):
    """Yield the plain run's carry before its first step and after each
    of ``steps`` steps.  The step updates the slot planes in place, so a
    yielded carry holds only until the next one is asked for."""
    yield carry
    for i in range(steps):
        carry = tuple(step_fn(carry, consts, i))
        yield carry


def check_case_claims(name):
    """Shapes, per-link timing, stalls under the stall modes, the tier
    of shared memory each case launches at on an H100 (the 14x14 case
    has more lanes (L * K) than a block has threads; ``just_fits`` is
    the widest ring-16 whose q_time plane fits), and clocks within a
    few hundred ns of ``BIG_NS`` or past it."""
    kw, arrays, _ = next((k, a, c) for n, k, a, c in multistep_cases()
                         if n == name)
    carry, consts, step_fn, plan = multistep_operands(kw, arrays, MS_STEPS,
                                                      CPU)
    claim = dict(CASE_CLAIMS[name])
    clocks = claim.pop("clocks", None)
    tier = claim.pop("tier")
    L, K, burst = plan.bucket[1], plan.bucket[7], plan.bucket[5]
    assert dict(L=L, K=K, max_burst=burst) == claim
    n_chips, n_routes = consts[1].shape[:2]
    shape = (L, K, plan.C, n_chips, n_routes)
    assert tfq.multistep_tier(*shape) == tier
    limit = tfq.H100_SMEM_OPTIN
    if name == "ring16_plane_just_fits":
        # one more event a chip (16 more columns) would not fit
        assert tfq.multistep_layout_bytes(*shape, 2) <= limit
        assert tfq.multistep_layout_bytes(
            L, K, plan.C + 16, n_chips, n_routes, 2) > limit
    if name == "ring16_plane_spills":
        assert tfq.multistep_layout_bytes(*shape, 2) > limit
    if name.startswith("mesh14x14"):
        assert L * K > 1024
    if name.startswith("ring40"):
        assert L > 32                        # a thread a link: two warps
    timing = consts[4]
    if name.startswith("ring32"):
        assert len(set(map(tuple, timing.T.tolist()))) == 2
    if clocks is not None:
        t_ch = tnet._MS_LANES.index("t")
        t_max = max(int(c[3][t_ch].max())
                    for c in plain_steps(clone(carry), consts, step_fn))
        if clocks == "near":
            assert BIG - 512 < t_max < BIG
        else:
            assert t_max >= BIG
        return
    want = run_schedule(
        lambda c, b, ch: tref.fabric_queue_multistep(
            c, consts, b, step_fn=step_fn, chunk=ch, max_steps=MS_STEPS),
        clone(carry), MS_STEPS, 128)
    stall_steps = int(want[4][tnet._MS_SIDES.index("stall_steps")].sum())
    assert stall_steps > 0 and int(want[6][0]) > 0


def windowed_scan(q_time, q_dest, t_q, n_ins):
    """The multi-step kernel's scan as a plain function: columns
    ``[0, clamp(n_ins, 0, C))`` of each row, the rest taken as unreleased
    ``BIG_NS`` slots; the full row where the clock is at or past
    ``BIG_NS``.  Returns ``(pend, r_min, nxt, amin)``."""
    nq, nc = q_time.shape
    w = n_ins.clamp(0, nc)
    full = t_q >= BIG
    col = torch.arange(nc)[None, :]
    inside = (col < w[:, None]) | full[:, None]
    released = inside & (q_time <= t_q[:, None])
    pend = released.sum(1, dtype=torch.int32)
    val = torch.where(released, q_time, BIG)
    r_min = val.amin(1)
    amin = val.argmin(1).to(torch.int32)
    nxt = torch.where(inside & ~released, q_time, BIG).amin(1)
    return pend, r_min, nxt, amin


def check_columns(name):
    """After every step of every multi-step case's plain run, the
    columns at or past ``n_ins[q]`` hold ``BIG_NS``, and the windowed
    scan gives ``ref.fabric_queue_scan``'s count, minimum and next
    release on every row, and its popped slot wherever the count is
    > 0."""
    kw, arrays, _ = next((k, a, c) for n, k, a, c in multistep_cases()
                         if n == name)
    carry, consts, step_fn, _ = multistep_operands(kw, arrays, MS_STEPS,
                                                   CPU)
    t_ch = tnet._MS_LANES.index("t")
    nins_ch = tnet._MS_SIDES.index("n_ins")
    for i, c in enumerate(plain_steps(clone(carry), consts, step_fn)):
        q_time, q_dest = c[0], c[1]
        nq, nc = q_time.shape
        n_ins = c[4][nins_ch].reshape(-1)
        past = torch.arange(nc)[None, :] >= n_ins[:, None]
        assert bool((q_time[past] == BIG).all()), (name, i)
        t_q = c[3][t_ch].repeat_interleave(2)
        want = tref.fabric_queue_scan(q_time, q_dest, t_q)
        got = windowed_scan(q_time, q_dest, t_q, n_ins)
        for k in range(3):
            assert torch.equal(got[k], want[k]), (name, i, k)
        busy = want[0] > 0
        assert torch.equal(got[3][busy], want[3][busy]), (name, i)
