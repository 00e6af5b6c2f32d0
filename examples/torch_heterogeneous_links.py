"""Per-link timing heterogeneity on the PyTorch port: fast on-board
buses and one slow LVDS link.

The port's counterpart of ``examples/heterogeneous_links.py``.  An
8-chip ring where link 7, the board-to-board cable, is the paper's
sub-word contract taken to bit-serial (1 wire, 26 beats, 331 ns an
event against 31 ns) carries the same Poisson traffic as the uniform
ring.  Both fabrics share one shape bucket (timing is a run operand),
and the report shows the per-link throughput and occupancy and the
latency deltas: the slow link holds back only the flows that cross it.

    PYTHONPATH=src python examples/torch_heterogeneous_links.py               # card
    PYTHONPATH=src python examples/torch_heterogeneous_links.py --device cpu

On the card the traffic is the port's own draw (a ``torch.Generator``
seeded with the reference example's key, 0), not the bits ``jax.random``
draws there, so the figures differ from the reference example's.
:func:`scenarios` takes the traffic, so the reference's arrays can be
passed in (``interop.from_reference``); every result then equals the
reference's bit for bit.
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import traffic as tr  # noqa: E402
from repro_torch.core.fabric import Fabric  # noqa: E402
from repro_torch.core.link import (PAPER_TIMING,  # noqa: E402
                                   SERIAL_LVDS_TIMING, per_link_timing)
from repro_torch.core.router import ring_topology  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

N_CHIPS = 8
SLOW_LINK = 7            # the ring's 7-0 edge: the "inter-board" hop
EVENTS_PER_CHIP = 48
SEED = 0                 # the reference example's jax.random.PRNGKey(0)
TOPO = ring_topology(N_CHIPS)
MIXED = per_link_timing(
    [PAPER_TIMING, SERIAL_LVDS_TIMING],
    [1 if l == SLOW_LINK else 0 for l in range(TOPO.n_links)])


def make_traffic() -> tr.TrafficSpec:
    return tr.poisson(torch.Generator().manual_seed(SEED), N_CHIPS,
                      EVENTS_PER_CHIP, mean_gap_ns=400.0)


def scenarios(spec: tr.TrafficSpec, device) -> dict:
    """The uniform and the mixed fabric on ``spec``, each compiled for
    its bucket first (one bucket serves both)."""
    cf_u = Fabric(TOPO, timing=PAPER_TIMING, device=device).compile(spec)
    cf_h = Fabric(TOPO, timing=MIXED, device=device).compile(spec)
    return {"bucket": cf_u.bucket, "shared": cf_u.bucket == cf_h.bucket,
            "uniform": cf_u.run(spec), "mixed": cf_h.run(spec)}


def stats_line(tag, res, timing):
    st = net.latency_stats(res)
    thr = float(net.fabric_throughput_mev_s(res))
    e_nj = float(net.fabric_energy_pj(res, timing)) * 1e-3
    print(f"  {tag:<12} delivered={st['delivered']}/{st['injected']} "
          f"thr={thr:5.1f}MEv/s p50={st['p50_ns']:6.0f}ns "
          f"p99={st['p99_ns']:6.0f}ns max={st['max_ns']:6d}ns "
          f"E={e_nj:.1f}nJ")
    return {**st, "mev_s": thr, "energy_nj": e_nj}


def per_link(res_u, res_h) -> dict:
    """Per-link throughput, bus occupancy (time moving events over the
    link-local clock) and traversals of both runs."""
    tc = np.asarray([PAPER_TIMING.t_req2req_ns] * TOPO.n_links)
    tc[SLOW_LINK] = SERIAL_LVDS_TIMING.t_req2req_ns
    sent_u = res_u.sent.cpu().numpy().sum(axis=1)
    sent_h = res_h.sent.cpu().numpy().sum(axis=1)
    return {
        "thr_u": net.per_link_throughput_mev_s(res_u).cpu().numpy(),
        "thr_h": net.per_link_throughput_mev_s(res_h).cpu().numpy(),
        "occ_u": 100.0 * sent_u * PAPER_TIMING.t_req2req_ns
        / res_u.t_link.cpu().numpy(),
        "occ_h": 100.0 * sent_h * tc / res_h.t_link.cpu().numpy(),
        "sent_h": sent_h}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = make_traffic()

    print(f"link classes: parallel bus {PAPER_TIMING.t_req2req_ns} ns/event"
          f" ({PAPER_TIMING.word_bits} wires) | serial LVDS "
          f"{SERIAL_LVDS_TIMING.t_req2req_ns} ns/event "
          f"({SERIAL_LVDS_TIMING.word_bits} wire) on link {SLOW_LINK}")
    res = scenarios(spec, dev)
    print(f"compiled bucket: {res['bucket']} "
          f"(shared by both fabrics: {res['shared']})")
    res_u, res_h = res["uniform"], res["mixed"]

    print("\n=== fabric totals ===")
    out = {"uniform": stats_line("uniform", res_u, PAPER_TIMING),
           "mixed": stats_line("mixed", res_h, MIXED)}

    # the slow link saturates while the parallel links stay mostly idle:
    # the bottleneck is local even though every flow crossing it stalls
    pl = per_link(res_u, res_h)
    print("\n=== per-link throughput (MEv/s) and bus occupancy ===")
    print(f"  {'link':<6}{'class':<10}{'thr(u)':>8}{'thr(m)':>8}"
          f"{'occ(u)':>8}{'occ(m)':>8}  hops")
    for l, (a, b) in enumerate(TOPO.links):
        cls = "lvds" if l == SLOW_LINK else "parallel"
        print(f"  {l}:{a}-{b:<3} {cls:<10}{pl['thr_u'][l]:>8.2f}"
              f"{pl['thr_h'][l]:>8.2f}{pl['occ_u'][l]:>7.0f}%"
              f"{pl['occ_h'][l]:>7.0f}%  {int(pl['sent_h'][l])}")

    lat_u = net.delivered_latencies(res_u)
    lat_h = net.delivered_latencies(res_h)
    d_p50 = np.percentile(lat_h, 50) - np.percentile(lat_u, 50)
    d_p99 = np.percentile(lat_h, 99) - np.percentile(lat_u, 99)
    print(f"\nlatency delta (mixed - uniform): p50 {d_p50:+.0f} ns, "
          f"p99 {d_p99:+.0f} ns")
    print("the long tail is the queue behind the serial link; the p50 "
          "barely moves because\nmost routes never cross it.")

    # everything delivers on both fabrics, and heterogeneity can only
    # stretch the end time
    assert int(res_u.delivered) == res_u.injected
    assert int(res_h.delivered) == res_h.injected
    assert int(res_h.t_end) >= int(res_u.t_end)
    print("\nOK")
    out.update(per_link=pl, d_p50_ns=float(d_p50), d_p99_ns=float(d_p99),
               bucket=res["bucket"], results=res,
               replay={"fabric": {"topo": TOPO, "timing": PAPER_TIMING},
                       "spec": spec, "result": res_u})
    return out


if __name__ == "__main__":
    main()
