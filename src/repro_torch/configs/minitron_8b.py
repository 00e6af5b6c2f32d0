"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].
Dense, GQA kv=8, squared-ReLU MLP (Nemotron family), 256k vocab."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256000, act="relu2")


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512)
