"""The paper's technique at the training level, on the PyTorch port:
data-parallel training where the gradient sync is the AER event-sparse
all-reduce (top-k + error feedback) or the bidirectional ring, against
the dense ``psum`` (``all_reduce``).

Runs 8 ranks, each one process (``mp.spawn``, rendezvous through a file
in a temporary directory), on the CUDA card(s) unless ``--device cpu``
says otherwise; without CUDA and without ``--device cpu`` it raises.
With 8 or more cards each rank takes its own and the collectives go
over NCCL.  With fewer, the 8 ranks share the cards (rank r on card r
mod the count) over gloo, and each collective stages the ranks' CUDA
tensors through host memory (``repro_torch.parallel.compat``): every
tensor of the step still lives on a card, and NCCL refuses two ranks on
one card.  The script says which transport it took.  ``--device cpu``
runs 8 gloo processes on the CPU.  Reports loss parity and wire volume
a step, as ``examples/sparse_allreduce_demo.py`` does for the JAX
package; ``main`` returns the device, the backend and each mode's
losses and wire words, and a failed rank makes it raise.

    PYTHONPATH=src python examples/torch_sparse_allreduce_demo.py
    PYTHONPATH=src python examples/torch_sparse_allreduce_demo.py \\
        --device cpu
    PYTHONPATH=src python examples/torch_sparse_allreduce_demo.py \\
        --steps 4                          # a short run
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 8
STEPS = 40
MODES = ("psum", "bidir_ring", "aer_topk")


def train(dp_reduce: str, device, steps: int = STEPS):
    """One mode's ``steps`` steps on this rank: its losses, wire words,
    the model's parameter count, the AER kernels' launches (B5, B6) and
    the mode's seconds."""
    from repro_torch.configs.base import RunConfig, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.aer_decode import aer_decode
    from repro_torch.kernels.aer_encode import aer_encode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime.train_loop import init_state, make_train_step
    cfg = get_smoke_config("granite_3_2b")
    t0 = time.perf_counter()
    run_cfg = RunConfig(learning_rate=3e-3, warmup_steps=4,
                        total_steps=steps, dp_reduce=dp_reduce,
                        aer_frac=0.05, aer_budget=128, fsdp=False)
    model = build_model(cfg, seed=0, device=device)
    mesh = make_host_mesh(data=WORLD, model=1)
    rules = make_rules(mesh, fsdp=False, kv_heads=cfg.n_kv_heads,
                       d_head=cfg.d_head)
    data = SyntheticLM(cfg.vocab, 32, 16, seed=7)
    state = init_state(model, run_cfg)
    step = make_train_step(model, run_cfg, rules)
    losses, words = [], 0.0
    aer_encode.launches = aer_decode.launches = 0
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        words += float(m["wire_words"])
    return {"losses": losses, "wire_words": words,
            "params": sum(p.numel() for p in model.parameters()),
            "launches": {"aer_encode": aer_encode.launches,
                         "aer_decode": aer_decode.launches},
            "seconds": time.perf_counter() - t0}


def _rank(rank, store_path, device_type, backend, out_path, steps):
    torch.set_num_threads(1)
    if device_type == "cuda":
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        device = torch.device("cuda", card)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        results = {mode: train(mode, device, steps) for mode in MODES}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _report(results, steps):
    from repro_torch.core import sparse_collectives as sc
    for mode in MODES:
        losses, words = results[mode]["losses"], results[mode]["wire_words"]
        print(f"{mode:11s} loss[0]={losses[0]:.4f} "
              f"loss[-1]={losses[-1]:.4f} wire_words/step="
              f"{words / steps:,.0f}")
    l_psum = results["psum"]["losses"][-1]
    l_ring = results["bidir_ring"]["losses"][-1]
    l_aer = results["aer_topk"]["losses"][-1]
    print(f"\nbidir_ring vs psum final-loss delta: {abs(l_ring - l_psum):.5f} "
          f"(exact schedule, must be ~float noise)")
    print(f"aer_topk  vs psum final-loss delta: {abs(l_aer - l_psum):.5f} "
          f"(5% events/step + error feedback)")
    n = results["psum"]["params"]
    dense_b = sc.dense_allreduce_bytes(n, WORLD)
    aer_words = results["aer_topk"]["wire_words"] / steps
    print(f"dense wire ≈ {dense_b:.3e} B/step/dir vs AER "
          f"{aer_words * 4:.3e} B/step ({dense_b / (aer_words * 4):.1f}x "
          f"less)", flush=True)


def main(argv=None):
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card(s)) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"steps a mode (default {STEPS})")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= WORLD else "gloo"
        if backend == "gloo":
            print(f"{WORLD} ranks share {cards} card(s) over gloo: each "
                  f"collective stages the ranks' CUDA tensors through "
                  f"host memory", flush=True)
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "results.json")
        mp.spawn(_rank, args=(os.path.join(d, "store"), dev.type, backend,
                              out_path, args.steps),
                 nprocs=WORLD, join=True)
        with open(out_path) as f:
            results = json.load(f)
    _report(results, args.steps)
    return {"device": dev.type, "backend": backend, "modes": results}


if __name__ == "__main__":
    main()
