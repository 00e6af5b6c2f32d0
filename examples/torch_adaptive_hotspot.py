"""Adaptive routing on a hot-spot ring, on the PyTorch port: telemetry
finds the saturated link, epochs spread the load.

The port's counterpart of ``examples/adaptive_hotspot.py``.  A 16-chip
ring where every chip fires mostly at chip 0.  Static shortest-path
routing sends each source down its shorter arc, so the two links next to
the hot chip saturate while the antipodal link idles, and with bounded
queues the hot arcs drop events.  ``AdaptiveRouting`` splits the run
into epochs, reads each epoch's per-link ``LinkLoad`` and re-weights the
next epoch's tables with the congestion signal; the report sets it
epoch by epoch beside static routing of the same workload under the
same epoch partition, and shows that one engine runner served every
epoch.

    PYTHONPATH=src python examples/torch_adaptive_hotspot.py               # card
    PYTHONPATH=src python examples/torch_adaptive_hotspot.py --device cpu

On the card the traffic is the port's own draw (a ``torch.Generator``
seeded with the reference example's key, 3), not the bits ``jax.random``
draws there, so the figures differ from the reference example's.
:func:`scenarios` takes the traffic, so the reference's arrays can be
passed in (``interop.from_reference``); every result then equals the
reference's bit for bit.
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import traffic as tr  # noqa: E402
from repro_torch.core.adaptive import AdaptiveRouting  # noqa: E402
from repro_torch.core.fabric import Fabric, QueuePolicy  # noqa: E402
from repro_torch.core.router import ring_topology  # noqa: E402
from repro_torch.core.telemetry import link_load  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

N_CHIPS = 16
EVENTS_PER_CHIP = 48
MEAN_GAP_NS = 100.0      # saturating arrival rate at the hot links
CAPACITY = 48            # per-endpoint budget: the hot arcs will drop
EPOCHS = 4
SEED = 3                 # the reference example's jax.random.PRNGKey(3)
POLICY = AdaptiveRouting(policy="min_backlog", epochs=EPOCHS, alpha=4.0,
                         ema=0.5)
TOPO = ring_topology(N_CHIPS)


def make_traffic() -> tr.TrafficSpec:
    return tr.hot_spot(torch.Generator().manual_seed(SEED), N_CHIPS,
                       EVENTS_PER_CHIP, mean_gap_ns=MEAN_GAP_NS)


def scenarios(spec: tr.TrafficSpec, device) -> dict:
    """The lossless static diagnosis run, then static ``run_epochs`` and
    the adaptive run under bounded queues."""
    diag = Fabric(TOPO, device=device).run(spec)
    queues = QueuePolicy(capacity=CAPACITY)
    static = Fabric(TOPO, queues=queues, device=device)
    res_s = static.run_epochs(spec, epochs=EPOCHS)
    adaptive = Fabric(TOPO, routing=POLICY, queues=queues, device=device)
    res_a = adaptive.run(spec)
    return {"diag": diag, "static": res_s, "adaptive": res_a,
            "static_report": static.last_report,
            "adaptive_report": adaptive.last_report}


def stats_line(tag, res) -> dict:
    st = net.latency_stats(res)
    print(f"  {tag:<9} delivered={st['delivered']}/{st['injected']} "
          f"drops={int(res.drops)} p50={st['p50_ns']:5.0f}ns "
          f"p99={st['p99_ns']:6.0f}ns max={st['max_ns']:6d}ns")
    return {**st, "drops": int(res.drops)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = make_traffic()
    res = scenarios(spec, dev)

    # --- 1. diagnose: telemetry of one lossless static run --------------
    print(f"=== static routing, lossless queues: per-link telemetry "
          f"(ring{N_CHIPS}, hot chip 0) ===")
    ll = link_load(res["diag"])
    print(ll.table(TOPO.links))
    occ = ll.occupancy
    print(f"  -> link 0 carries {100 * occ.max():.0f}% bus occupancy; "
          f"the antipodal link sits at {100 * occ.min():.0f}% — the "
          f"shared-arc bottleneck, not link bandwidth, is the limit")
    assert occ.max() > 0.9, "expected a saturated hot link"
    assert occ.min() < 0.3, "expected idle capacity on the far arc"

    # --- 2. act: epoch-adaptive routing vs static, bounded queues -------
    res_s, res_a = res["static"], res["adaptive"]
    print(f"\n=== bounded queues (capacity {CAPACITY}/endpoint), "
          f"{EPOCHS} epochs: static vs adaptive ===")
    out = {"static": stats_line("static", res_s),
           "adaptive": stats_line("adaptive", res_a)}

    report = res["adaptive_report"]
    print(f"\n=== epoch by epoch: telemetry-reweighted tables vs the "
          f"same epochs on static tables ===")
    print(f"  {'epoch':<7}{'s.drops':>8}{'a.drops':>8}{'s.p99':>8}"
          f"{'a.p99':>8}  note")
    epochs = []
    for e, (rs, ra) in enumerate(zip(res["static_report"].records,
                                     report.records)):
        note = ("identical tables (epoch 0 IS static)" if e == 0 else
                "tables re-weighted by epoch %d telemetry" % (e - 1))
        row = (int(rs.load.drops.sum()), int(ra.load.drops.sum()),
               net.latency_stats(rs.result)["p99_ns"],
               net.latency_stats(ra.result)["p99_ns"])
        epochs.append(row)
        print(f"  {e:<7}{row[0]:>8}{row[1]:>8}{row[2]:>8.0f}{row[3]:>8.0f}"
              f"  {note}")

    # --- the fabric's claims ----------------------------------------------
    assert int(res_a.delivered) + int(res_a.drops) == res_a.injected
    assert int(res_s.delivered) + int(res_s.drops) == res_s.injected
    # whether adaptive beats static on drops and on p99 depends on the
    # draw (ROADMAP queue C: the reference fails both on its own traffic
    # under jax 0.9), so the two are printed, not asserted
    p99_s, p99_a = out["static"]["p99_ns"], out["adaptive"]["p99_ns"]
    # one engine runner served every epoch (tables are run operands)
    assert not report.recompiled
    print(f"\nadaptive against static: {int(res_s.drops) - int(res_a.drops)}"
          f" drops and {p99_s - p99_a:.0f} ns of p99 saved with "
          f"{len(report.buckets)} engine compilation(s) for "
          f"{report.n_epochs} epochs")
    print("OK")
    out.update(occupancy=occ, link_load=ll, epochs=epochs,
               drops_saved=int(res_s.drops) - int(res_a.drops),
               p99_saved_ns=p99_s - p99_a, buckets=report.buckets,
               recompiled=report.recompiled, results=res,
               replay={"fabric": {"topo": TOPO}, "spec": spec,
                       "result": res["diag"]})
    return out


if __name__ == "__main__":
    main()
