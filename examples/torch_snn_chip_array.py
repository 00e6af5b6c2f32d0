"""The paper's 2D neuromorphic chip array (§IV / Fig. 6), closed loop
through the fabric, on the PyTorch port.

The port's counterpart of ``examples/snn_chip_array.py``.  A 4x4 mesh of
LIF chips (one population a chip) runs with every border-crossing spike
routed as a 26-bit Address-Event through a credit-flow-controlled
``Fabric``: each chip's neighbour projection fans out over its 2-4 mesh
neighbours as an in-fabric multicast tree, and delivered events feed
back into the next tick's membrane currents.  Each tick's membrane
update is one launch of the LIF kernel on the card.  The bus figures
come from the fabric's own transmission and busy-time telemetry
(``snn.fabric_report``), and the run checks:

  * exact conservation: per tick, delivered + drops == injected;
  * losslessness: credit flow control delivers everything, no drops;
  * the wire economy (28 against 56 wires a link).

    PYTHONPATH=src python examples/torch_snn_chip_array.py               # card
    PYTHONPATH=src python examples/torch_snn_chip_array.py --device cpu

On the card the weights and the Poisson drive are the port's own draw (a
``torch.Generator`` seeded with the reference example's key, 42), not
the bits ``jax.random`` draws there, so the figures differ from the
reference example's.  :func:`scenario` takes the weights and the
per-tick drive, so the reference's can be passed in
(``interop.cosim_weights_from_reference``; the drive as a (T, P, n)
bool array).
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.fabric import QueuePolicy  # noqa: E402
from repro_torch.core.router import AddressSpec, mesh2d_topology  # noqa: E402
from repro_torch.cosim import (CosimConfig, CosimEngine,  # noqa: E402
                               Population, Projection, place)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import snn  # noqa: E402

ROWS, COLS = 4, 4
NEURONS = 256            # a chip (2 rows of 128 LIF lanes)
TICKS = 24
TICK_DT_NS = 100_000     # 100 us a network tick (10 kHz update)
SEED = 42                # the reference example's jax.random.PRNGKey(42)
CAPACITY = 512
CFG = CosimConfig(input_rate=0.08, tick_dt_ns=TICK_DT_NS)
#: membrane updates of the run (one LIF launch each)
TICKS_RUN = TICKS


def build_placement():
    """One population a mesh chip; a local recurrent projection plus a
    neighbour projection that fans out over the chip's 4-neighbourhood
    (multicast tags, replicated on Steiner trees inside the fabric)."""
    pops = [Population(f"chip{r}{c}", NEURONS)
            for r in range(ROWS) for c in range(COLS)]
    projs = []
    for r in range(ROWS):
        for c in range(COLS):
            i = r * COLS + c
            nbrs = tuple((rr * COLS + cc) for rr, cc in
                         ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1))
                         if 0 <= rr < ROWS and 0 <= cc < COLS)
            projs.append(Projection(pre=i, posts=(i,), w_scale=0.3))
            projs.append(Projection(pre=i, posts=nbrs, w_scale=0.25))
    return place(pops, projs, mesh2d_topology(ROWS, COLS),
                 chips=range(ROWS * COLS), addr=AddressSpec())


def scenario(device, weights=None, drive=None):
    """The closed loop over the credit fabric, on ``weights`` and
    ``drive`` where given, else on a network drawn from ``SEED``,
    keeping the membranes and every tick's fabric result.  Returns the
    placement and the run's ``CosimResult``."""
    pl = build_placement()
    fab = pl.fabric(queues=QueuePolicy(capacity=CAPACITY, flow="credit"),
                    device=device)
    eng = CosimEngine(pl, CFG, fabric=fab, device=device,
                      generator=torch.Generator().manual_seed(SEED),
                      weights=weights)
    return pl, eng.run(TICKS, drive=drive, record_state=True,
                       record_fabric=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pl = build_placement()
    n_mcast = sum(1 for r in pl.cross if r.tag >= 0)
    print(f"{ROWS}x{COLS} chip mesh, {NEURONS} LIF neurons/chip, "
          f"{TICKS} ticks")
    print(f"  placement             : {len(pl.projections)} projections -> "
          f"{len(pl.local)} local routes + {len(pl.cross)} cross routes "
          f"({n_mcast} multicast tags)")
    _, res = scenario(dev)

    assert res.conservation_exact, "delivered + drops != injected"
    assert int(res.drops.sum()) == 0, "credit flow control dropped events"
    assert int(res.delivered.sum()) == int(res.injected.sum())
    rate = res.total_spikes / (TICKS * pl.n_pops * NEURONS)
    print(f"  mean firing rate      : {rate:.4f} /neuron/tick")
    print(f"  conservation          : delivered {int(res.delivered.sum())} "
          f"+ drops {int(res.drops.sum())} == injected "
          f"{int(res.injected.sum())}  (exact, every tick)")
    lat = None
    if res.latency_ns.size:
        lat = (int(np.percentile(res.latency_ns, 50)),
               int(np.percentile(res.latency_ns, 99)),
               int(res.latency_ns.max()))
        print(f"  fabric latency        : p50 {lat[0]} ns, p99 {lat[1]} ns, "
              f"max {lat[2]} ns")

    rep = snn.fabric_report(res, TICKS, tick_dt_us=TICK_DT_NS / 1e3)
    print(f"  inter-chip events     : {rep['events_total']:.0f} delivered "
          f"({rep['events_per_s']:.3e} ev/s aggregate, "
          f"{rep['traversals']} link traversals)")
    print(f"  bus occupancy         : mean {rep['bus_busy_frac']:.3%}, "
          f"busiest link {rep['max_link_busy_frac']:.3%} of wall time "
          f"(measured busy-ns telemetry)")
    print(f"  energy (AER transfer) : {rep['energy_uj']:.3f} uJ @ 11 "
          f"pJ/event-hop (per-traversal, multicast billed on tree edges)")
    print(f"  wires per link        : {rep['shared_bus_wires_per_link']} "
          f"shared-bus vs {rep['dual_bus_wires_per_link']} dual-bus "
          f"(paper: 100 pins saved on 4 borders)")
    print("  OK — closed-loop conservation + lossless credit delivery")
    return {"rate": rate, "delivered": int(res.delivered.sum()),
            "injected": int(res.injected.sum()), "latency_ns": lat,
            "report": rep, "ticks_run": TICKS_RUN, "result": res}


if __name__ == "__main__":
    main()
