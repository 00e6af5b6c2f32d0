#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  It needs one card
and no network, builds the kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (into the git-ignored ``build/``), and imports nothing of
JAX or of the JAX reference package.  Phases, one JSON line each:

1. device    — name, capability (must be 9.0), nvidia-smi name and power
               limit (also printed raw on a line of its own);
2. build     — both libraries, one nvcc each, started together: seconds
               and ptxas's resource report;
3. kernels   — the per-step pair (B1, B2) against their plain PyTorch
               versions on the card, bit for bit, at (Q, C) in {(4, 7),
               (32, 768), (224, 3072)} and K in {1, 4}, with every edge
               case of the contract; then each timed with CUDA events at
               the ring-16 full-width shape, beside its plain version and
               its bound;
4. multistep — the multi-step kernel (B3) against its plain version on
               packed carries of real plans (tests/_torch_cases.py):
               the three cells' specs plus ring-16 at a binding capacity
               under credit, drop and on/off, ring-32 with per-link
               timing and max_burst 2 under on/off, the 2x4 mesh
               multicast (K = 2) under credit and a 14x14 mesh multicast
               (K = 3, 1,092 lanes) under credit, 300 steps each at
               chunk 1, 16 and/or 128 (launches with base > 0, max_steps
               binding mid-chunk), and one B = 3 launch (the three
               binding ring-16 cases) against their solo plain runs;
               then one launch timed at full width, beside its bound and
               its plain version;
5. anchor    — the paper's Fig. 8 cell (ring-2 ping-pong, 1024 events a
               side, max_burst 1) through the default engine: 28.6 MEv/s
               within 0.1 %, and equal to ``protocol_sim.simulate``;
6. full      — ring-16 hot-spot (48 events a chip, mean gap 300 ns,
               hot_frac 0.65, capacity 64, credit flow): the per-step
               kernel engine against ``engine="reference"`` on the card,
               field for field, every event delivered, no drops, and
               exactly 2·max_steps kernel launches; then an 8-chip
               in-fabric multicast run with K > 1, compared the same way;
7. multistep path — each of those three cells again through
               ``EngineSpec("pallas", kernel="multistep")`` at chunk 128:
               equal to its per-step result field for field, exactly
               ceil(max_steps / 128) B3 launches and no B1/B2 launch;
8. profile   — torch.profiler windows of the full-width cell on both
               paths: device-busy share and time by kernel.

Then the ``{"kernels": [...]}`` summary, the nvidia-smi line again and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and the last line is never printed.  Without
CUDA (or outside a checkout of the repository) it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate (data sheet)
# H100 SXM int32 rate: 64 INT32 lanes per SM and clock x 132 SMs x
# 1.98 GHz boost (the data sheet's 67 TFLOP/s fp32 counts 128 fp32 lanes
# and an FMA as two operations); the kernels' operations are int32
INT32_OPS_S = 64 * 132 * 1.98e9
ANCHOR_MEV_S, ANCHOR_TOL = 28.6, 0.001


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# The inputs (numpy, seeded) are the tests' own, in tests/_torch_cases.py:
# the queue kernels' edge cases (all-BIG_NS rows, fully released rows,
# ties, values next to BIG_NS, clocks at / past it, lanes whose queue id
# is >= Q), the cells' traffic, and the multi-step kernel's cases.

# --- timing --------------------------------------------------------------

def time_ms(fn, n=2000, warm=200) -> float:
    """Mean ms per call over ``n`` calls, timed with CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0)) or 0)


def device_ms(fn, n=500):
    """Mean device (kernel) ms per call over ``n`` calls, summed over the
    kernels the call launches, from torch.profiler; None when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_device_us(e) for e in prof.key_averages())
    return total_us / n / 1e3 if total_us > 0 else None


# --- phases --------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(tuple(cap) == (9, 0), f"capability {cap}, expected (9, 0)")
    return name, smi


LIBRARIES = ("fabric_queue", "fabric_queue_multistep")


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        built = list(ex.map(_build.build, LIBRARIES))
    wall = time.perf_counter() - t0
    libs = {}
    for name, (path, secs, log) in zip(LIBRARIES, built):
        _build.load(name)
        libs[name] = {"library": str(path.relative_to(ROOT)),
                      "nvcc_s": secs,
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling entry" in ln]}
    emit("build", wall_s=wall, libraries=libs)


def phase_kernels():
    """Bit-exactness on the card, then times at the full-width shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import ref
    from _torch_cases import planes, scan_case, update_case
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)

    def t(a):
        return torch.tensor(a, device=dev)

    worst = {"fabric_queue_step": 0, "fabric_queue_update": 0}
    cases = []
    for nq, nc in ((4, 7), (32, 768), (224, 3072)):
        q, qd, tq = scan_case(rng, nq, nc)
        got = fq.fabric_queue_step(t(q), t(qd), t(tq))
        want = ref.fabric_queue_scan(t(q), t(qd), t(tq))
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        worst["fabric_queue_step"] = max(worst["fabric_queue_step"], err)
        for k in (1, 4):
            pl = planes(rng, nq, nc)
            lanes = update_case(rng, nq, nc, k)
            got = fq.fabric_queue_update(*map(t, pl), *map(t, lanes))
            want = ref.fabric_queue_update(*map(t, pl), *map(t, lanes))
            torch.cuda.synchronize()
            e2 = max(int((g.long() - w.long()).abs().max()) for g, w in
                     zip(got, want))
            worst["fabric_queue_update"] = max(
                worst["fabric_queue_update"], e2)
            cases.append({"Q": nq, "C": nc, "K": k, "scan_err": err,
                          "update_err": e2})
    emit("kernels_vs_plain", cases=cases, max_abs_err=worst,
         equal=all(v == 0 for v in worst.values()))
    check(all(v == 0 for v in worst.values()),
          f"kernels disagree with their plain versions: {worst}")

    # times at the ring-16 full-width shape: Q = 32, C = 768, 16 pop
    # lanes and 16 append lanes (K = 1)
    nq, nc, k = 32, 768, 1
    q, qd, tq = (t(a) for a in scan_case(rng, nq, nc))
    lanes = [t(a) for a in update_case(rng, nq, nc, k)]
    qplanes = [t(a) for a in planes(rng, nq, nc)]
    calls = {
        "fabric_queue_step": (
            lambda: fq.fabric_queue_step(q, qd, tq),
            lambda: ref.fabric_queue_scan(q, qd, tq)),
        "fabric_queue_update": (
            lambda: fq.fabric_queue_update(*qplanes, *lanes),
            lambda: ref.fabric_queue_update(*qplanes, *lanes)),
    }
    # device time per call (profiler) and per-call time of back-to-back
    # calls (CUDA events: bounded by the host's dispatch rate)
    timing = {name: {"device_ms": device_ms(kern),
                     "call_ms": time_ms(kern),
                     "plain_device_ms": device_ms(plain),
                     "plain_call_ms": time_ms(plain)}
              for name, (kern, plain) in calls.items()}
    # bounds from these inputs: each input read once, each output
    # written once (the update writes only its valid lanes)
    pop_q, pop_slot, app_q = (a.cpu().numpy() for a in lanes[:3])
    lp, la = len(pop_q), len(app_q)
    n_pop_w = int((pop_q < nq).sum())
    n_app_w = int((app_q < nq).sum())
    step_bytes = 4 * (nq * nc + nq + 6 * nq + nq)   # q_time, t_q, outs,
    step_ops = 4 * nq * nc                          # + head_route reads
    upd_bytes = 4 * (2 * lp + 5 * la + n_pop_w + 3 * n_app_w)
    upd_ops = lp + la
    bounds = {
        "fabric_queue_step": (step_bytes, step_ops),
        "fabric_queue_update": (upd_bytes, upd_ops),
    }
    out = {}
    for name, (b, o) in bounds.items():
        tb, to = b / HBM_BYTES_S * 1e3, o / INT32_OPS_S * 1e3
        tm = timing[name]
        seen = tm["device_ms"] is not None and \
            tm["plain_device_ms"] is not None
        out[name] = {"ms": tm["device_ms"] if seen else tm["call_ms"],
                     "plain_ms": (tm["plain_device_ms"] if seen
                                  else tm["plain_call_ms"]),
                     "ms_source": ("profiler device time per call" if seen
                                   else "CUDA events, back-to-back calls"),
                     **tm,
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": b, "ops": o,
                     "max_abs_err": worst[name]}
    emit("kernel_times", shape={"Q": nq, "C": nc, "Lp": lp, "La": la},
         kernels=out)
    return out


def phase_multistep_kernel():
    """B3 against its plain version on the card, bit for bit, on packed
    carries of real plans; then one launch timed at full width."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.kernels import fabric_queue as fq
    from repro_torch.kernels import ref
    from _torch_cases import (MS_BATCH, MS_STEPS, carry_err, clone,
                              multistep_cases, multistep_operands,
                              run_schedule)
    dev = torch.device("cuda", 0)

    def plain(carry, consts, step_fn, steps=MS_STEPS, chunk=128):
        return run_schedule(
            lambda c, b, ch: ref.fabric_queue_multistep(
                c, consts, b, step_fn=step_fn, chunk=ch, max_steps=steps),
            clone(carry), steps, chunk)

    def kernel(carry, consts, chunk, max_burst, steps=MS_STEPS):
        return run_schedule(
            lambda c, b, ch: fq.fabric_queue_multistep(
                c, consts, b, chunk=ch, max_steps=steps,
                max_burst=max_burst),
            clone(carry), steps, chunk)

    def err_of(want, got, n_log):
        torch.cuda.synchronize()
        err = carry_err(want, got, n_log)
        check(err is not None, "multistep carry changed shape or dtype")
        return err

    cases, solo, worst = [], {}, 0
    for name, kw, arrays, chunks in multistep_cases():
        carry, consts, step_fn, plan = multistep_operands(kw, arrays,
                                                          MS_STEPS, dev)
        t0 = time.perf_counter()
        want = plain(carry, consts, step_fn)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        solo[name] = (carry, consts, want, plan)
        for chunk in chunks:
            err = err_of(want, kernel(carry, consts, chunk, plan.bucket[5]),
                         plan.E)
            worst = max(worst, err)
            cases.append({"case": name, "chunk": chunk,
                          "launches": -(-MS_STEPS // chunk),
                          "L": plan.bucket[1], "K": plan.bucket[7],
                          "max_burst": plan.bucket[5], "flow": plan.fc,
                          "cap": plan.cap, "max_abs_err": err,
                          "delivered": int(want[6][0]),
                          "drops": int(want[6][1]),
                          "stall_steps": int(want[4][5].sum()),
                          "plain_s": plain_s})
    parts = [solo[n] for n in MS_BATCH]
    carry = tuple(torch.stack([p[0][j] for p in parts]) for j in range(7))
    consts = tuple(torch.stack([p[1][j] for p in parts]) for j in range(6))
    got = kernel(carry, consts, 128, parts[0][3].bucket[5])
    batch_err = max(err_of(p[2], tuple(g[i] for g in got), p[3].E)
                    for i, p in enumerate(parts))
    worst = max(worst, batch_err)
    emit("multistep_vs_plain", steps=MS_STEPS, cases=cases,
         batch={"instances": list(MS_BATCH), "chunk": 128,
                "max_abs_err": batch_err},
         max_abs_err=worst, equal=worst == 0)
    check(worst == 0, f"multistep kernel disagrees with its plain version "
                      f"(max abs err {worst})")
    by = {c["case"]: c for c in cases}
    check(by["ring16_drop"]["drops"] > 0, "drop case dropped nothing")
    check(by["ring16_credit_tight"]["stall_steps"] > 0
          and by["ring16_onoff"]["stall_steps"] > 0,
          "credit / on-off cases never stalled")
    check(by["mesh2x4_multicast"]["K"] == 2, "multicast case has K != 2")
    ring32, credit2, wide = (by[n] for n in (
        "ring32_perlink_burst_onoff", "mesh2x4_multicast_credit",
        "mesh14x14_multicast_credit"))
    check(ring32["L"] == 32 and ring32["max_burst"] == 2
          and ring32["stall_steps"] > 0,
          "ring-32 case: expected 32 links, max_burst 2 and on/off stalls")
    check(credit2["K"] == 2 and credit2["stall_steps"] > 0,
          "K = 2 credit case never stalled")
    check(wide["K"] == 3 and wide["L"] * wide["K"] > 1024
          and wide["stall_steps"] > 0,
          "14x14 case: expected K = 3, over 1024 lanes and credit stalls")

    # one launch (base 0, chunk 128) at the full-width shape: the
    # ring-16 credit cell's reset-time carry, a fresh copy per launch
    kw, arrays = next((k, a) for n, k, a, _ in multistep_cases()
                      if n == "ring16_credit")
    carry, consts, step_fn, plan = multistep_operands(kw, arrays, None, dev)
    steps, chunk = plan.max_steps, 128
    base = torch.zeros(1, dtype=torch.int32, device=dev)
    n_steps = min(chunk, steps)

    def launch(c):
        return fq.fabric_queue_multistep(c, consts, base, chunk=chunk,
                                         max_steps=steps, max_burst=0)

    got = launch(clone(carry))
    want = plain(carry, consts, step_fn, steps=n_steps, chunk=chunk)
    timing_err = err_of(want, got, plan.E)
    check(timing_err == 0, "timed launch disagrees with its plain version")
    n = 50
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for (a, b), c in zip(ev, copies):
        a.record()
        launch(c)
        b.record()
    torch.cuda.synchronize()
    event_ms = sum(a.elapsed_time(b) for a, b in ev) / n
    from torch.profiler import ProfilerActivity, profile
    copies = [clone(carry) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in copies:
            launch(c)
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages()
                 if "fabric_queue_multistep" in e.key)
    device_ms = dev_us / n / 1e3 if dev_us > 0 else None
    reps = 2
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        plain(carry, consts, step_fn, steps=n_steps, chunk=chunk)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b) / reps
    # bounds from this launch's inputs: the carry read once and written
    # once plus the constants read once; the operations are the scan's
    # compare / select / min / count over every slot, every step (the
    # per-link and per-lane work is far smaller)
    L, q, c = plan.sizes.shape[0], 2 * plan.sizes.shape[0], plan.C
    byts = 2 * net.slot_carry_bytes(L, plan.E, c) + 4 + sum(
        4 * t.numel() for t in consts)
    ops = n_steps * 4 * q * c
    tb, to = byts / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    out = {"ms": device_ms if device_ms is not None else event_ms,
           "ms_source": ("profiler device time per launch"
                         if device_ms is not None
                         else "CUDA events around each launch"),
           "device_ms": device_ms, "event_ms": event_ms,
           "plain_ms": plain_ms, "bound_ms": max(tb, to),
           "bound_by": "bytes" if tb >= to else "operations",
           "bytes": byts, "ops": ops,
           "scan_traffic_bound_ms": n_steps * q * c * 4 / HBM_BYTES_S * 1e3,
           "steps_per_launch": n_steps, "max_abs_err": worst}
    emit("multistep_kernel_time",
         shape={"L": L, "Q": q, "C": c, "E": plan.E, "chunk": chunk,
                "carry_bytes": net.slot_carry_bytes(L, plan.E, c)},
         **out)
    return out


def phase_anchor():
    import numpy as np
    import torch
    from repro_torch.core import network as net
    from repro_torch.core import protocol_sim as ps
    from repro_torch.core.fabric import Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.kernels import fabric_queue as fq
    from _torch_cases import anchor_arrays, spec_of
    n = 1024
    spec = spec_of(*anchor_arrays(n))
    fab = Fabric(ring_topology(2), queues=QueuePolicy(max_burst=1))
    cf = fab.compile(spec)
    check(cf.bucket == ("pallas", 1, 2048, 2048, 12480, 1, 2, 1, "step",
                        0), f"anchor bucket {cf.bucket}")
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    t0 = time.perf_counter()
    res = cf.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fq.fabric_queue_step.launches,
                fq.fabric_queue_update.launches)
    thr = float(net.fabric_throughput_mev_s(res))
    err = abs(thr - ANCHOR_MEV_S) / ANCHOR_MEV_S
    sim = ps.simulate(np.zeros(n, np.int32), np.zeros(n, np.int32),
                      initial_tx=1, max_burst=1)
    torch.cuda.synchronize()
    act, t_tr = sim.trace.action.cpu().numpy(), sim.trace.t.cpu().numpy()
    d = int(res.delivered)
    dlv = res.log_del[:d].cpu().numpy()
    dst = res.log_dest[:d].cpu().numpy()
    same = (int(res.t_end) == int(sim.t_end)
            and res.sent.cpu().tolist() == [[int(sim.sent_l),
                                             int(sim.sent_r)]]
            and int(res.n_switches[0]) == int(sim.n_switches)
            and np.array_equal(np.sort(t_tr[act == ps.A_TX_L]),
                               np.sort(dlv[dst == 1]))
            and np.array_equal(np.sort(t_tr[act == ps.A_TX_R]),
                               np.sort(dlv[dst == 0])))
    emit("anchor", thr_mev_s=thr, paper_mev_s=ANCHOR_MEV_S, rel_err=err,
         delivered=d, t_end=int(res.t_end), bucket=list(cf.bucket),
         launches=list(launches), wall_s=wall,
         us_per_step=wall / cf.bucket[4] * 1e6, equals_simulate=same)
    check(err <= ANCHOR_TOL, f"anchor {thr} MEv/s off 28.6 by {err:.3%}")
    check(same, "ring-2 fabric differs from protocol_sim.simulate")
    check(d == 2 * n, "anchor did not deliver every event")
    return ("anchor", dict(topo=ring_topology(2),
                           queues=QueuePolicy(max_burst=1)), spec, res)


def _run_pair(fab_kw, spec, label):
    """One spec through the kernel engine and the plain engine on the
    card; returns (kernel result, bucket, launches, wall seconds)."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import fabric_queue as fq
    fab = Fabric(**fab_kw, engine="pallas")
    cf = fab.compile(spec)
    torch.cuda.synchronize()
    fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
    t0 = time.perf_counter()
    res = cf.run(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fabric_queue_step": fq.fabric_queue_step.launches,
                "fabric_queue_update": fq.fabric_queue_update.launches}
    t0 = time.perf_counter()
    ref = Fabric(**fab_kw, engine="reference").run(spec)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    net.assert_results_equal(res, ref, label)
    steps = cf.bucket[4]
    emit(label, bucket=list(cf.bucket), steps=steps,
         delivered=int(res.delivered), injected=res.injected,
         drops=int(res.drops), launches=launches, wall_s=wall,
         us_per_step=wall / steps * 1e6, reference_wall_s=ref_wall,
         reference_us_per_step=ref_wall / steps * 1e6,
         equals_reference=True,
         thr_mev_s=float(net.fabric_throughput_mev_s(res)),
         latency=net.latency_stats(res))
    check(all(v == steps for v in launches.values()),
          f"{label}: launches {launches}, expected {steps} each "
          f"(2·max_steps in all)")
    return res, cf.bucket, launches, wall


def phase_full():
    from repro_torch.core.fabric import MulticastPolicy, QueuePolicy
    from repro_torch.core.router import (AddressSpec, MulticastTable,
                                         mesh2d_topology, ring_topology)
    from _torch_cases import hot_spot_arrays, mesh_multicast_case, spec_of
    spec = spec_of(*hot_spot_arrays(16, 48, 300.0, 0.65, seed=2))
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    res, bucket, launches, _ = _run_pair(kw, spec, "full_ring16_credit")
    check(int(res.delivered) == res.injected and int(res.drops) == 0,
          "credit flow lost events")

    # in-fabric multicast on 8 chips with a branching tree (K = 2): on a
    # ring every tree node past the source has one way onward (K = 1), so
    # the 8-chip fabric here is the 2x4 mesh
    members, arrays = mesh_multicast_case(8 * 24)
    mspec = spec_of(*arrays)
    mkw = dict(topo=mesh2d_topology(2, 4), addr=AddressSpec(),
               mcast=MulticastPolicy("in_fabric", MulticastTable(members)))
    mres, mbucket, _, _ = _run_pair(mkw, mspec, "multicast_mesh2x4")
    check(mbucket[7] > 1, f"multicast K = {mbucket[7]}, expected > 1")
    check(int(mres.delivered) == mres.injected, "multicast lost events")
    cells = [("full_ring16_credit", kw, spec, res),
             ("multicast_mesh2x4", mkw, mspec, mres)]
    return spec, kw, bucket, launches, cells


def phase_multistep_path(cells):
    """Each cell through ``kernel="multistep"`` at chunk 128, held field
    for field against its per-step result (itself held against
    ``engine="reference"``); returns the launch counts by cell."""
    import torch
    from repro_torch.core import network as net
    from repro_torch.core.fabric import EngineSpec, Fabric
    from repro_torch.kernels import fabric_queue as fq
    counted = {}
    for label, kw, spec, step_res in cells:
        cf = Fabric(**kw, engine=EngineSpec("pallas", kernel="multistep")
                    ).compile(spec)
        torch.cuda.synchronize()
        fq.fabric_queue_step.launches = fq.fabric_queue_update.launches = 0
        fq.fabric_queue_multistep.launches = 0
        t0 = time.perf_counter()
        res = cf.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fq, k).launches for k in (
            "fabric_queue_step", "fabric_queue_update",
            "fabric_queue_multistep")}
        net.assert_results_equal(res, step_res, f"{label} multistep")
        steps, chunk = cf.bucket[4], cf.bucket[9]
        thr = float(net.fabric_throughput_mev_s(res))
        emit(f"{label}_multistep", bucket=list(cf.bucket), steps=steps,
             launches=launches, wall_s=wall, us_per_step=wall / steps * 1e6,
             equals_step=True, thr_mev_s=thr,
             delivered=int(res.delivered), drops=int(res.drops))
        check(chunk == 128, f"{label}: chunk {chunk}, expected 128")
        check(launches == {"fabric_queue_step": 0, "fabric_queue_update": 0,
                           "fabric_queue_multistep": -(-steps // chunk)},
              f"{label}: launches {launches}, expected ceil({steps} / "
              f"{chunk}) of fabric_queue_multistep and no other")
        if label == "anchor":
            check(abs(thr - ANCHOR_MEV_S) / ANCHOR_MEV_S <= ANCHOR_TOL,
                  f"multistep anchor reads {thr} MEv/s")
        counted[label] = launches
    return counted


def aten_ops_per_step(fab, spec, steps: int) -> float:
    """PyTorch operator calls per micro-transaction (dispatcher count
    over a ``steps``-step run of the fabric's engine)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fab.run(spec, max_steps=steps)
    return Count.n / steps


def phase_profile(spec, kw, engine="pallas", steps=300, label="profile"):
    """Device-busy share and kernel time by name over a window of
    ``steps`` micro-transactions (None: the whole run) of the cell
    through ``engine``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fabric import Fabric
    fab = Fabric(**kw, engine=engine)
    cf = fab.compile(spec, max_steps=steps)
    cf.run(spec, max_steps=steps)            # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cf.run(spec, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = cf.bucket[4]
    rows = []
    for e in prof.key_averages():
        dev_us = _device_us(e)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    ops = aten_ops_per_step(fab, spec, steps=20)
    if busy_us == 0:
        emit(label, steps=steps, wall_s=wall, aten_ops_per_step=ops,
             device_busy="not measured")
        return
    emit(label, steps=steps, wall_s=wall,
         us_per_step=wall / steps * 1e6,
         device_busy_us_per_step=busy_us / steps,
         device_busy_share=busy_us / (wall * 1e6),
         aten_ops_per_step=ops,
         kernels_per_step=sum(r[2] for r in rows) / steps,
         top=[{"kernel": k[:80], "us_per_step": us / steps,
               "calls_per_step": c / steps} for us, k, c in rows[:12]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures "
              "the port on the GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, smi = phase_device()
    torch.cuda.synchronize()
    phase_build()
    torch.cuda.synchronize()
    ktimes = phase_kernels()
    torch.cuda.synchronize()
    ktimes["fabric_queue_multistep"] = phase_multistep_kernel()
    torch.cuda.synchronize()
    anchor = phase_anchor()
    torch.cuda.synchronize()
    spec, kw, bucket, launches, cells = phase_full()
    torch.cuda.synchronize()
    ms_launches = phase_multistep_path([anchor] + cells)
    torch.cuda.synchronize()
    phase_profile(spec, kw)
    torch.cuda.synchronize()
    from repro_torch.core.fabric import EngineSpec
    ms_engine = EngineSpec("pallas", kernel="multistep")
    phase_profile(spec, kw, engine=ms_engine, steps=None,
                  label="profile_multistep")
    torch.cuda.synchronize()

    csrc = "src/repro_torch/kernels/csrc/"
    main = {"fabric_queue_step": (launches["fabric_queue_step"], bucket),
            "fabric_queue_update": (launches["fabric_queue_update"], bucket),
            "fabric_queue_multistep": (
                ms_launches["full_ring16_credit"]["fabric_queue_multistep"],
                bucket[:8] + ("multistep", 128))}
    source = {"fabric_queue_step": csrc + "fabric_queue.cu",
              "fabric_queue_update": csrc + "fabric_queue.cu",
              "fabric_queue_multistep": csrc + "fabric_queue_multistep.cu"}
    replaces = {"fabric_queue_step":
                "src/repro/kernels/fabric_queue.py:109",
                "fabric_queue_update":
                "src/repro/kernels/fabric_queue.py:195",
                "fabric_queue_multistep":
                "src/repro/kernels/fabric_queue.py:238"}
    kernels = []
    for kname, k in ktimes.items():
        n_launch, path_bucket = main[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source[kname],
            "replaces": replaces[kname], "launches": n_launch,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "equal": k["max_abs_err"] == 0, "us": k["ms"] * 1e3,
            "main_path_bucket": list(path_bucket)})
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
