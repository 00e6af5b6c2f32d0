"""Closed-loop SNN <-> fabric co-simulation on a 16-chip AER ring, on
the PyTorch port.

The port's counterpart of ``examples/closed_loop_snn.py``.  A recurrent
LIF network (forward and backward ring projections plus local
recurrence, one population a chip) runs with its inter-chip spikes
carried by a credit-flow-controlled ``Fabric``, and the delivered events
fed back into later membrane updates.  Every membrane update is one
launch of the LIF kernel on the card.  The run shows, in order:

  1. transport adds nothing: the open loop (``feedback="none"``) equals
     a standalone LIF rollout (``reference_rollout``) bit for bit;
  2. a lossless closed loop: under credit flow control every tick has
     delivered + drops == injected, with no drops;
  3. the loop is real: closed-loop spike counts diverge from the open
     loop's;
  4. congestion couples back: on slow serial links with
     ``feedback="measured"``, deliveries cross tick boundaries and the
     late current changes the spiking against the idealised
     ``next_tick`` mode on the same fabric.

    PYTHONPATH=src python examples/torch_closed_loop_snn.py               # card
    PYTHONPATH=src python examples/torch_closed_loop_snn.py --device cpu

On the card the weights and the Poisson drive are the port's own draw (a
``torch.Generator`` seeded with the reference example's key, 7), not the
bits ``jax.random`` draws there, so the figures differ from the
reference example's.  :func:`scenarios` takes the weights and the
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
from repro_torch.core.link import SERIAL_LVDS_TIMING  # noqa: E402
from repro_torch.core.router import AddressSpec, ring_topology  # noqa: E402
from repro_torch.cosim import (CosimConfig, CosimEngine,  # noqa: E402
                               Population, Projection, place,
                               reference_rollout)
from repro_torch.device import resolve_device  # noqa: E402

N_CHIPS = 16
NEURONS = 128
TICKS = 32
SEED = 7                 # the reference example's jax.random.PRNGKey(7)
CAPACITY = 256
#: membrane updates the example makes: the rollout, the open loop, the
#: closed loop and the two serial-link runs (one LIF launch each)
TICKS_RUN = 5 * TICKS


def build_placement():
    """Recurrent ring: chip i drives chips i+1 and i-1 (unicast cross
    routes) and itself (local, never touches the fabric)."""
    pops = [Population(f"pop{i}", NEURONS) for i in range(N_CHIPS)]
    projs = []
    for i in range(N_CHIPS):
        projs.append(Projection(pre=i, posts=((i + 1) % N_CHIPS,),
                                w_scale=0.4))
        projs.append(Projection(pre=i, posts=((i - 1) % N_CHIPS,),
                                w_scale=0.4))
        projs.append(Projection(pre=i, posts=(i,), w_scale=0.3))
    return place(pops, projs, ring_topology(N_CHIPS), addr=AddressSpec())


def scenarios(device, weights=None, drive=None) -> dict:
    """The five runs on one network, each keeping its membranes (and
    the closed loops every tick's fabric result).  Every engine takes
    ``weights`` ((n_proj, n, n) float32) and ``drive`` ((TICKS, P, n)
    bool) where given, else draws them from a generator of ``SEED``
    (the same network for every engine, as the reference's one key
    gives)."""
    pl = build_placement()
    rec = {"record_state": True, "record_fabric": True}

    def engine(cfg, fabric=None):
        return CosimEngine(pl, cfg, fabric=fabric, device=device,
                           generator=torch.Generator().manual_seed(SEED),
                           weights=weights)

    out = {"placement": pl}
    eng_open = engine(CosimConfig(feedback="none"))
    out["rollout"] = reference_rollout(eng_open, TICKS, record_state=True,
                                       drive=drive)
    out["open"] = eng_open.run(TICKS, record_state=True, drive=drive)
    fab = pl.fabric(queues=QueuePolicy(capacity=CAPACITY, flow="credit"),
                    device=device)
    out["closed"] = engine(CosimConfig(feedback="next_tick"),
                           fab).run(TICKS, drive=drive, **rec)
    # measured feedback on slow serial links: congestion-delayed current
    # against idealised next-tick delivery, same fabric and network
    cfg_m = CosimConfig(feedback="measured", tick_dt_ns=600)
    for label, cfg in (("measured", cfg_m),
                       ("next_tick", cfg_m._replace(feedback="next_tick"))):
        f = pl.fabric(timing=SERIAL_LVDS_TIMING,
                      queues=QueuePolicy(capacity=CAPACITY, flow="credit"),
                      device=device)
        out[label] = engine(cfg, f).run(TICKS, drive=drive, **rec)
    out["tick_dt_ns"] = cfg_m.tick_dt_ns
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"recurrent ring, {N_CHIPS} chips x {NEURONS} LIF neurons, "
          f"{TICKS} ticks")
    runs = scenarios(dev)

    # 1. open loop == standalone rollout, bit for bit
    ref, opn = runs["rollout"], runs["open"]
    assert np.array_equal(ref.v, opn.v)
    assert np.array_equal(ref.raster, opn.raster)
    print(f"  open loop == reference : bit-exact over {TICKS} ticks "
          f"({opn.total_spikes} spikes)")

    # 2. + 3. closed loop over a lossless credit fabric
    res = runs["closed"]
    assert res.conservation_exact
    assert int(res.drops.sum()) == 0
    assert int(res.delivered.sum()) == int(res.injected.sum())
    print("  tick   spikes  offered  injected  delivered  drops")
    for t in list(range(4)) + [TICKS - 1]:
        print(f"  {t:4d} {int(res.spikes[t].sum()):8d} "
              f"{int(res.offered[t]):8d} {int(res.injected[t]):9d} "
              f"{int(res.delivered[t]):10d} {int(res.drops[t]):6d}")
    print(f"  total conservation     : delivered {int(res.delivered.sum())}"
          f" + drops 0 == injected {int(res.injected.sum())} "
          f"(exact, every tick; credit flow => lossless)")
    diverge = int(np.abs(res.spikes - opn.spikes).sum())
    assert diverge > 0, "fabric feedback left the dynamics unchanged"
    print(f"  closed vs open loop    : spike trajectories diverge by "
          f"{diverge} (the feedback loop is real)")

    # 4. measured feedback on slow serial links
    res_m, res_i = runs["measured"], runs["next_tick"]
    dt = runs["tick_dt_ns"]
    assert res_m.conservation_exact and res_i.conservation_exact
    lag = int(res_m.latency_ns.max()) / dt
    delayed = int((res_m.latency_ns >= dt).sum())
    gap = int(np.abs(res_m.spikes - res_i.spikes).sum())
    assert delayed > 0, "serial links never crossed a tick boundary"
    assert gap > 0, "delivery timing did not affect the dynamics"
    print(f"  measured feedback      : serial links stretch delivery to "
          f"{lag:.1f} ticks worst-case; {delayed} events land >=1 tick "
          f"late")
    print(f"  measured vs next_tick  : spike trajectories diverge by "
          f"{gap} — fabric congestion perturbs the network dynamics")
    print("  OK — closed-loop contracts all hold")
    return {"open_spikes": opn.total_spikes,
            "closed_delivered": int(res.delivered.sum()),
            "closed_injected": int(res.injected.sum()),
            "divergence": diverge, "lag_ticks": lag,
            "late_events": delayed, "measured_gap": gap,
            "ticks_run": TICKS_RUN, "runs": runs}


if __name__ == "__main__":
    main()
