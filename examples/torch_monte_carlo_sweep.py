"""Monte-Carlo fabric sweep on the PyTorch port: 64 seeds of one
scenario, one batched run.

The port's counterpart of ``examples/monte_carlo_sweep.py``.  The
question a fabric architect asks is statistical ("what is the p99
delivery latency of this topology under hot-spot load?"), and one seed
is an anecdote.  ``traffic.monte_carlo`` draws 64 independently seeded
instances of the hot-spot scenario, and ``Fabric.sweep_batch`` runs all
of them as one batched computation (``run_batch``): the instance axis
rides through the whole engine, so the sweep binds one batched runner
however many seeds there are (checked below with ``batch_cache_size``),
and each instance equals a solo ``fab.run`` of its spec.

    PYTHONPATH=src python examples/torch_monte_carlo_sweep.py               # card
    PYTHONPATH=src python examples/torch_monte_carlo_sweep.py --device cpu

The scenario is the reference benchmark's ``BATCH_RING``
(``benchmarks/fabric_sweep.py``), copied here with ``EVENTS_PER_CHIP``:
that module imports JAX, which the port's machine does not have.  On the
card the traffic is the port's own draw (``monte_carlo`` on a
``torch.Generator`` seeded with the reference's key, 7), not the bits
``jax.random`` draws there, so the figures differ from the reference
example's.  :func:`sweep` takes the specs, so the reference's arrays can
be passed in (``interop.from_reference``); every instance then equals
the reference's bit for bit.
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import network as net  # noqa: E402
from repro_torch.core import traffic as tr  # noqa: E402
from repro_torch.core.fabric import Fabric, batch_cache_size  # noqa: E402
from repro_torch.core.router import ring_topology  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

# copies of benchmarks/fabric_sweep.py:42 and :401
EVENTS_PER_CHIP = 48
BATCH_RING = dict(n_chips=16, key=7, epc=EVENTS_PER_CHIP,
                  pattern="hot_spot")
N_SEEDS = 64
TOPO = ring_topology(BATCH_RING["n_chips"])


def make_traffic() -> list:
    cfg = BATCH_RING
    return tr.monte_carlo(cfg["pattern"],
                          torch.Generator().manual_seed(cfg["key"]),
                          N_SEEDS, cfg["n_chips"], cfg["epc"])


def sweep(specs: list, device):
    """All ``specs`` as one batched run (warmed first), and the batched
    runners the process then holds for its bucket."""
    fab = Fabric(TOPO, device=device)
    cell = fab.sweep_batch(specs)
    return cell, batch_cache_size(cell.bucket, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = BATCH_RING
    specs = make_traffic()
    n_seeds = len(specs)
    print(f"=== {n_seeds}-seed Monte-Carlo: {cfg['pattern']} on a "
          f"ring-{cfg['n_chips']}, {cfg['epc']} events/chip ===")
    cell, n_compiles = sweep(specs, dev)
    batch = cell.result

    # the sweep bound one batched runner
    assert n_compiles == 1, f"expected 1 batched runner, saw {n_compiles}"

    # conservation holds per seed: nothing is lost silently
    delivered = batch.delivered.cpu().numpy()
    drops = batch.drops.cpu().numpy()
    assert (delivered + drops == batch.injected).all(), "conservation"

    # per-seed latency stats: the spread that one seed cannot show
    stats = net.batch_latency_stats(batch)
    p50 = np.array([s["p50_ns"] for s in stats])
    p99 = np.array([s["p99_ns"] for s in stats])
    thr = net.batch_throughput_mev_s(batch).cpu().numpy()
    print(f"  delivered {int(delivered.sum())}/{int(batch.injected.sum())}"
          f" events across {n_seeds} seeds "
          f"(drops: {int(drops.sum())}, charged per seed)")
    print(f"  p50  across seeds: {p50.min():5.0f} .. {p50.max():5.0f} ns "
          f"(median {np.median(p50):.0f})")
    print(f"  p99  across seeds: {p99.min():5.0f} .. {p99.max():5.0f} ns "
          f"(median {np.median(p99):.0f}, worst seed "
          f"#{int(p99.argmax())})")
    print(f"  throughput: {thr.mean():.1f} MEv/s mean, "
          f"{thr.min():.1f} MEv/s worst seed")
    print(f"  one batched run: {cell.us_per_call / 1e3:.0f} ms total"
          f" = {cell.us_per_instance / 1e3:.1f} ms/seed amortized, "
          f"{n_compiles} batched runner on {dev}")

    # the tail is a property of the distribution, not of one seed
    spread = p99.max() / max(p99.min(), 1.0)
    print(f"  -> p99 varies {spread:.1f}x across seeds of the SAME "
          f"scenario: sizing from one seed under-provisions the tail")
    return {"n_seeds": n_seeds, "delivered": delivered, "drops": drops,
            "p50_ns": p50, "p99_ns": p99, "mev_s": thr,
            "p99_spread": spread, "n_compiles": n_compiles,
            "ms_total": cell.us_per_call / 1e3,
            "ms_per_seed": cell.us_per_instance / 1e3, "batch": batch,
            "replay": {"fabric": {"topo": TOPO}, "spec": specs[0],
                       "result": batch.instance(0)}}


if __name__ == "__main__":
    main()
