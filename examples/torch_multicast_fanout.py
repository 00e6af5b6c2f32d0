"""In-fabric multicast replication against source expansion, side by
side, on the PyTorch port.

The port's counterpart of ``examples/multicast_fanout.py``.  The same
fanout-8 tagged workload crosses a 16-chip ring both ways:

    Fabric(topo, addr=addr, mcast=MulticastPolicy("source_expand", mc))
    Fabric(topo, addr=addr, mcast=MulticastPolicy("in_fabric", mc))

Five members sit clockwise behind the shared 0-1-2-3 path and three
counter-clockwise behind 0-15-14-13, so source expansion pays for every
copy on every shared link while the replication tree pays once an edge.
Both deliver the same destination multiset; the difference is transport
cost: link traversals, energy and the latency tail.

    PYTHONPATH=src python examples/torch_multicast_fanout.py               # card
    PYTHONPATH=src python examples/torch_multicast_fanout.py --device cpu

The workload draws nothing (48 tagged events from chip 0, 300 ns apart),
so the card runs the reference example's traffic exactly.
:func:`scenarios` takes the traffic all the same, so a test can pass in
the reference's arrays (``interop.from_reference``).
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import traffic as tr  # noqa: E402
from repro_torch.core.fabric import Fabric, MulticastPolicy  # noqa: E402
from repro_torch.core.link import PAPER_TIMING  # noqa: E402
from repro_torch.core.router import (AddressSpec,  # noqa: E402
                                     MulticastTable, MulticastTree,
                                     RoutingTable, ring_topology)
from repro_torch.device import resolve_device  # noqa: E402

N_CHIPS = 16
MEMBERS = np.arange(4, 12)      # fanout 8 from chip 0
N_EVENTS = 48
MODES = ("source_expand", "in_fabric")
TOPO = ring_topology(N_CHIPS)
ADDR = AddressSpec()


def multicast_table() -> MulticastTable:
    members = np.zeros((1, N_CHIPS), bool)
    members[0, MEMBERS] = True
    return MulticastTable(members)


def make_traffic() -> tr.TrafficSpec:
    return tr.TrafficSpec(
        src=torch.zeros(N_EVENTS, dtype=torch.int32),
        t=torch.arange(N_EVENTS, dtype=torch.int32) * 300,
        dest=torch.from_numpy(ADDR.pack_multicast(
            np.zeros(N_EVENTS, np.int64))))


def fabric_kwargs(mode: str) -> dict:
    return {"topo": TOPO, "addr": ADDR,
            "mcast": MulticastPolicy(mode, multicast_table())}


def scenarios(spec: tr.TrafficSpec, device) -> dict:
    """``spec`` under each multicast mode."""
    return {mode: Fabric(**fabric_kwargs(mode), device=device).run(spec)
            for mode in MODES}


def stats_line(tag, res) -> dict:
    st = net.latency_stats(res)
    e_nj = float(net.fabric_energy_pj(res, PAPER_TIMING)) * 1e-3
    print(f"  {tag:<14} delivered={st['delivered']}/{st['injected']} "
          f"fanout={st['fanout']:.0f} traversals={st['traversals']:4d} "
          f"p50={st['p50_ns']:5.0f}ns p99={st['p99_ns']:5.0f}ns "
          f"E={e_nj:.1f}nJ")
    return {**st, "energy_nj": e_nj}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = make_traffic()

    print(f"ring{N_CHIPS}, tag 0 = chips {MEMBERS.min()}..{MEMBERS.max()} "
          f"(fanout {len(MEMBERS)}), {N_EVENTS} tagged events from chip 0")

    # the replication tree the in_fabric mode routes along
    rt = RoutingTable.build(TOPO)
    tree = MulticastTree.build(TOPO, rt, 0, MEMBERS)
    hops = int(rt.hops[0, MEMBERS].sum())
    print(f"\nSteiner-branching tree: {tree.n_edges} edges vs "
          f"{hops} per-copy hops -> {hops - tree.n_edges} link traversals "
          f"saved PER EVENT")

    results = scenarios(spec, dev)
    print("\n=== fabric totals ===")
    out = {mode: stats_line(mode, res) for mode, res in results.items()}
    se, infab = results["source_expand"], results["in_fabric"]

    # per-link traversal counts: where the savings live
    sent_se = se.sent.cpu().numpy().sum(axis=1)
    sent_if = infab.sent.cpu().numpy().sum(axis=1)
    print("\n=== per-link traversals (source_expand vs in_fabric) ===")
    print(f"  {'link':<8}{'source':>8}{'infabric':>10}  saved")
    for l, (a, b) in enumerate(TOPO.links):
        if sent_se[l] or sent_if[l]:
            print(f"  {l}:{a}-{b:<4}{sent_se[l]:>8}{sent_if[l]:>10}"
                  f"  {sent_se[l] - sent_if[l]:+d}")

    # the contract
    assert int(se.delivered) == se.injected == N_EVENTS * len(MEMBERS)
    assert int(infab.delivered) == infab.injected == se.injected
    assert net.delivery_multiset(se) == net.delivery_multiset(infab)
    assert infab.traversals == N_EVENTS * tree.n_edges
    assert infab.traversals < se.traversals
    saved = 100.0 * (1.0 - infab.traversals / se.traversals)
    print(f"\nidentical delivery multiset; {saved:.0f}% of link "
          f"traversals (and link energy) saved in-fabric")
    print("OK")
    out.update(tree_edges=tree.n_edges, per_copy_hops=hops,
               sent_source=sent_se, sent_in_fabric=sent_if,
               saved_pct=saved, results=results,
               replay={"fabric": fabric_kwargs("source_expand"),
                       "spec": spec, "result": se})
    return out


if __name__ == "__main__":
    main()
