"""Multi-chip AER fabric demo on the PyTorch port: the paper's link,
scaled to a system.

The port's counterpart of ``examples/multi_chip_fabric.py``.  It builds
an 8-chip ring and a 4x4 mesh out of bi-directional transceiver links,
pushes Poisson background traffic plus a multicast population broadcast
(tag expansion) through them, and prints the same report: delivery and
latency percentiles, fabric throughput against the single-link ceiling,
the busiest link and its direction switches, and the energy at 11 pJ a
hop.  The ring fabric is compiled once and reused across workloads; the
mesh goes through the one-shot ``network.simulate_fabric``.

    PYTHONPATH=src python examples/torch_multi_chip_fabric.py               # card
    PYTHONPATH=src python examples/torch_multi_chip_fabric.py --device cpu

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
from repro_torch.core.link import PAPER_TIMING  # noqa: E402
from repro_torch.core.router import (AddressSpec,  # noqa: E402
                                     MulticastTable, mesh2d_topology,
                                     ring_topology)
from repro_torch.device import resolve_device  # noqa: E402

EVENTS_PER_CHIP = 64
SEED = 0                 # the reference example's jax.random.PRNGKey(0)
N_BCAST = 24
RING = ring_topology(8)
MESH = mesh2d_topology(4, 4)
ADDR = AddressSpec()     # [mcast | 8-bit chip | 17-bit neuron tag]


def multicast_table() -> MulticastTable:
    groups = np.zeros((2, 8), bool)
    groups[0, :4] = True          # tag 0: chips 0-3 (a population)
    groups[1, ::2] = True         # tag 1: the even chips
    return MulticastTable(groups)


def make_traffic() -> dict:
    """The three workloads: Poisson on the ring, the tagged broadcast
    (fixed, no draw) and the mesh hot spot, each drawn from a fresh
    generator of ``SEED``, as the reference draws both from one key."""
    i = np.arange(N_BCAST, dtype=np.int32)
    bcast = tr.TrafficSpec(
        src=torch.zeros(N_BCAST, dtype=torch.int32),
        t=torch.arange(N_BCAST, dtype=torch.int32) * 500,
        dest=torch.from_numpy(ADDR.pack_multicast(i % 2, core=i)))
    return {
        "poisson": tr.poisson(torch.Generator().manual_seed(SEED),
                              RING.n_chips, EVENTS_PER_CHIP,
                              mean_gap_ns=300.0),
        "broadcast": bcast,
        "hot_spot": tr.hot_spot(torch.Generator().manual_seed(SEED),
                                MESH.n_chips, EVENTS_PER_CHIP // 2,
                                hot_chip=5, hot_frac=0.6)}


def scenarios(traffic: dict, device) -> dict:
    """The three runs of the reference example on ``traffic``
    (:func:`make_traffic`'s keys): the ring compiled once for its bucket
    and reused, then the mesh through ``simulate_fabric``."""
    ring_fab = Fabric(RING, device=device)
    cf = ring_fab.compile(traffic["poisson"])   # pre-warm the shape bucket
    out = {"poisson": cf.run(traffic["poisson"])}
    mc_fab = Fabric(RING, addr=ADDR, mcast=multicast_table(), device=device)
    out["broadcast"] = mc_fab.run(traffic["broadcast"])
    out["hot_spot"] = net.simulate_fabric(MESH, traffic["hot_spot"],
                                          device=device)
    return out


def summary(res) -> dict:
    """The figures :func:`report` prints."""
    return {**net.latency_stats(res), "drops": int(res.drops),
            "mev_s": float(net.fabric_throughput_mev_s(res)),
            "busiest_link_mev_s": float(
                net.per_link_throughput_mev_s(res).max()),
            "max_switches": int(res.n_switches.max()),
            "energy_pj": float(net.fabric_energy_pj(res, PAPER_TIMING))}


def report(tag, topo, res) -> dict:
    s = summary(res)
    print(f"\n=== {tag} ({topo.name}: {topo.n_chips} chips, "
          f"{topo.n_links} links) ===")
    print(f"  delivered        : {s['delivered']}/{s['injected']} "
          f"(drops={s['drops']})")
    print(f"  latency          : p50={s['p50_ns']:.0f}ns "
          f"p90={s['p90_ns']:.0f}ns p99={s['p99_ns']:.0f}ns "
          f"max={s['max_ns']}ns")
    print(f"  fabric throughput: {s['mev_s']:.1f} MEv/s "
          f"(single link ceiling {PAPER_TIMING.onedir_throughput_mev_s():.1f})")
    print(f"  busiest link     : {s['busiest_link_mev_s']:.1f} MEv/s, "
          f"{s['max_switches']} direction switches")
    print(f"  energy           : {s['energy_pj'] / 1e3:.2f} nJ "
          f"({PAPER_TIMING.e_event_pj} pJ/hop)")
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    traffic = make_traffic()
    res = scenarios(traffic, dev)
    out = {
        "poisson": report("Poisson background", RING, res["poisson"]),
        "broadcast": report("Multicast broadcast (tag expansion)", RING,
                            res["broadcast"]),
        "hot_spot": report("Hot-spot convergecast", MESH, res["hot_spot"])}
    print("\nThe N=2 degenerate fabric reproduces the measured two-block "
          "link bit-exactly\n(tests/test_torch_fabric.py::"
          "test_two_chip_fabric_is_simulate); "
          "everything above is that same\nFSM pair, run across links.")
    out["results"] = res
    out["replay"] = {"fabric": {"topo": RING}, "spec": traffic["poisson"],
                     "result": res["poisson"]}
    return out


if __name__ == "__main__":
    main()
