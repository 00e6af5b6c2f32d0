"""Qwen3-14B — [hf:Qwen/Qwen3-14B family]. Dense, GQA kv=8, qk-norm,
head_dim 128 (40 heads x 128 = 5120)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_head=128, d_ff=17408, vocab=151936,
    act="silu", qk_norm=True)


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512)
