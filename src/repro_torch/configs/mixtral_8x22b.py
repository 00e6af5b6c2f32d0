"""Mixtral-8x22B — [arXiv:2401.04088]. 8 experts top-2, SWA window 4096.
E=8 < tp=16, so the reference's experts use the "tp" layout."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, act="silu",
    sliding_window=4096,
    moe=MoeConfig(num_experts=8, top_k=2, layout="tp"))


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512, sliding_window=16,
                        moe=MoeConfig(num_experts=4, top_k=2, layout="tp"))
