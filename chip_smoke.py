#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  It needs one card
and no network, builds the kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (into the git-ignored ``build/``), and imports nothing of
JAX or of the JAX reference package.  Phases, one JSON line each:

1. device   — name, capability (must be 9.0), nvidia-smi name and power
              limit (also printed raw on a line of its own);
2. build    — nvcc seconds and ptxas's resource report;
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card, bit for bit, at (Q, C) in {(4, 7), (32, 768),
              (224, 3072)} and K in {1, 4}, with every edge case of the
              contract; then each timed with CUDA events at the ring-16
              full-width shape, beside its plain version and its bound;
4. anchor   — the paper's Fig. 8 cell (ring-2 ping-pong, 1024 events a
              side, max_burst 1) through the default engine: 28.6 MEv/s
              within 0.1 %, and equal to ``protocol_sim.simulate``;
5. full     — ring-16 hot-spot (48 events a chip, mean gap 300 ns,
              hot_frac 0.65, capacity 64, credit flow): the kernel
              engine against ``engine="reference"`` on the card, field
              for field, every event delivered, no drops, and exactly
              2·max_steps kernel launches; then an 8-chip in-fabric
              multicast run with K > 1, compared the same way;
6. profile  — a short torch.profiler window of the full-width run:
              device-busy share and time by kernel.

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
CUDA_CORE_OPS_S = 67e12      # H100 SXM non-tensor-core fp32 rate; used
#                              as the int32 ALU ceiling (an upper bound)
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


# --- inputs (numpy, seeded) ----------------------------------------------
# The kernels' edge-case inputs are the tests' own (tests/_torch_cases.py):
# all-BIG_NS rows, fully released rows, ties, values next to BIG_NS,
# clocks at / past it, and lanes whose queue id is >= Q.

def hot_spot(n_chips, epc, mean_gap_ns, hot_frac, seed, hot_chip=0):
    """Numpy hot-spot traffic with the reference generator's contract."""
    import numpy as np
    rng = np.random.default_rng(seed)
    col = np.repeat(np.arange(n_chips)[:, None], epc, 1)
    times = np.cumsum(rng.exponential(mean_gap_ns, (n_chips, epc))
                      .astype(np.int64), 1)
    d = rng.integers(0, n_chips - 1, col.shape)
    uni = d + (d >= col)
    hot = (rng.random(col.shape) < hot_frac) & (col != hot_chip)
    dest = np.where(hot, hot_chip, uni)
    return col.reshape(-1), times.reshape(-1), dest.reshape(-1)


def spec_of(src, t, dest):
    import numpy as np
    import torch
    from repro_torch.core.traffic import TrafficSpec
    return TrafficSpec(*(torch.from_numpy(np.asarray(a, np.int32))
                         for a in (src, t, dest)))


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


def phase_build():
    from repro_torch.kernels import _build
    path, secs, log = _build.build("fabric_queue")
    _build.load("fabric_queue")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", library=str(path.relative_to(ROOT)), nvcc_s=secs,
         ptxas=ptxas)


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
        tb, to = b / HBM_BYTES_S * 1e3, o / CUDA_CORE_OPS_S * 1e3
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


def phase_anchor():
    import numpy as np
    import torch
    from repro_torch.core import network as net
    from repro_torch.core import protocol_sim as ps
    from repro_torch.core.fabric import Fabric, QueuePolicy
    from repro_torch.core.router import ring_topology
    from repro_torch.kernels import fabric_queue as fq
    n = 1024
    spec = spec_of(np.r_[np.zeros(n), np.ones(n)], np.zeros(2 * n),
                   np.r_[np.ones(n), np.zeros(n)])
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
    import numpy as np
    from repro_torch.core.fabric import MulticastPolicy, QueuePolicy
    from repro_torch.core.router import (AddressSpec, MulticastTable,
                                         mesh2d_topology, ring_topology)
    spec = spec_of(*hot_spot(16, 48, 300.0, 0.65, seed=2))
    kw = dict(topo=ring_topology(16),
              queues=QueuePolicy(capacity=64, flow="credit"))
    res, bucket, launches, _ = _run_pair(kw, spec, "full_ring16_credit")
    check(int(res.delivered) == res.injected and int(res.drops) == 0,
          "credit flow lost events")

    # in-fabric multicast on 8 chips with a branching tree (K = 2): on a
    # ring every tree node past the source has one way onward (K = 1), so
    # the 8-chip fabric here is the 2x4 mesh
    addr = AddressSpec()
    members = np.zeros((2, 8), bool)
    members[0, [3, 6]] = True
    members[1, [1, 2, 5, 7]] = True
    rng = np.random.default_rng(8)
    n = 8 * 24
    src = rng.integers(0, 8, n)
    t = np.sort(rng.integers(0, 20_000, n))
    tag = rng.integers(0, 2, n)
    src[tag == 0] = 0
    dest = addr.pack_multicast(tag)
    order = np.lexsort((t, src))
    mspec = spec_of(src[order], t[order], dest[order])
    mkw = dict(topo=mesh2d_topology(2, 4), addr=addr,
               mcast=MulticastPolicy("in_fabric", MulticastTable(members)))
    mres, mbucket, _, _ = _run_pair(mkw, mspec, "multicast_mesh2x4")
    check(mbucket[7] > 1, f"multicast K = {mbucket[7]}, expected > 1")
    check(int(mres.delivered) == mres.injected, "multicast lost events")
    return spec, kw, bucket, launches


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


def phase_profile(spec, kw):
    """Device-busy share and kernel time by name over a short window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fabric import Fabric
    steps = 300
    fab = Fabric(**kw, engine="pallas")
    cf = fab.compile(spec, max_steps=steps)
    cf.run(spec, max_steps=steps)            # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cf.run(spec, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = _device_us(e)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    ops = aten_ops_per_step(fab, spec, steps=20)
    if busy_us == 0:
        emit("profile", steps=steps, wall_s=wall, aten_ops_per_step=ops,
             device_busy="not measured")
        return
    emit("profile", steps=steps, wall_s=wall,
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
    phase_anchor()
    torch.cuda.synchronize()
    spec, kw, bucket, launches = phase_full()
    torch.cuda.synchronize()
    phase_profile(spec, kw)
    torch.cuda.synchronize()

    src = "src/repro_torch/kernels/csrc/fabric_queue.cu"
    replaces = {"fabric_queue_step":
                "src/repro/kernels/fabric_queue.py:109",
                "fabric_queue_update":
                "src/repro/kernels/fabric_queue.py:195"}
    kernels = []
    for kname, k in ktimes.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "equal": k["max_abs_err"] == 0, "us": k["ms"] * 1e3,
            "main_path_bucket": list(bucket)})
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
