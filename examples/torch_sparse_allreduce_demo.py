"""The paper's technique at the training level, on the PyTorch port:
data-parallel training where the gradient sync is the AER event-sparse
all-reduce (top-k + error feedback) or the bidirectional ring, against
the dense ``psum`` (``all_reduce``).

Runs 8 ranks: gloo processes on the CPU by default, or NCCL over 8
cards with ``--device cuda``; each rank is one process (``mp.spawn``,
rendezvous through a file in a temporary directory).  Reports loss
parity and wire volume a step, as ``examples/sparse_allreduce_demo.py``
does for the JAX package.

    PYTHONPATH=src python examples/torch_sparse_allreduce_demo.py
    PYTHONPATH=src python examples/torch_sparse_allreduce_demo.py \\
        --device cuda                      # a host with 8 cards
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 8
STEPS = 40
MODES = ("psum", "bidir_ring", "aer_topk")


def train(dp_reduce: str, device):
    from repro_torch.configs.base import RunConfig, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.runtime.train_loop import init_state, make_train_step
    cfg = get_smoke_config("granite_3_2b")
    run_cfg = RunConfig(learning_rate=3e-3, warmup_steps=4,
                        total_steps=STEPS, dp_reduce=dp_reduce,
                        aer_frac=0.05, aer_budget=128, fsdp=False)
    model = build_model(cfg, seed=0, device=device)
    mesh = make_host_mesh(data=WORLD, model=1)
    rules = make_rules(mesh, fsdp=False, kv_heads=cfg.n_kv_heads,
                       d_head=cfg.d_head)
    data = SyntheticLM(cfg.vocab, 32, 16, seed=7)
    state = init_state(model, run_cfg)
    step = make_train_step(model, run_cfg, rules)
    losses, words = [], 0.0
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        words += float(m["wire_words"])
    return losses, words, sum(p.numel() for p in model.parameters())


def _rank(rank, store_path, device_type):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        results = {}
        for mode in MODES:
            results[mode] = train(mode, device)
            if rank == 0:
                losses, words, _ = results[mode]
                print(f"{mode:11s} loss[0]={losses[0]:.4f} "
                      f"loss[-1]={losses[-1]:.4f} wire_words/step="
                      f"{words / STEPS:,.0f}", flush=True)
        if rank == 0:
            _report(results)
    finally:
        dist.destroy_process_group()


def _report(results):
    from repro_torch.core import sparse_collectives as sc
    l_psum = results["psum"][0][-1]
    l_ring = results["bidir_ring"][0][-1]
    l_aer = results["aer_topk"][0][-1]
    print(f"\nbidir_ring vs psum final-loss delta: {abs(l_ring - l_psum):.5f} "
          f"(exact schedule, must be ~float noise)")
    print(f"aer_topk  vs psum final-loss delta: {abs(l_aer - l_psum):.5f} "
          f"(5% events/step + error feedback)")
    n = results["psum"][2]
    dense_b = sc.dense_allreduce_bytes(n, WORLD)
    aer_words = results["aer_topk"][1] / STEPS
    print(f"dense wire ≈ {dense_b:.3e} B/step/dir vs AER "
          f"{aer_words * 4:.3e} B/step ({dense_b / (aer_words * 4):.1f}x "
          f"less)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"--device cuda needs {WORLD} cards, this host "
                         f"has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(os.path.join(d, "store"), args.device),
                 nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
