"""Moonlight-16B-A3B (moonshot) — [hf:moonshotai/Moonlight-16B-A3B].
Fine-grained MoE: 64 experts top-6, per-expert d_ff=1408, MHA kv=16."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840, act="silu",
    moe=MoeConfig(num_experts=64, top_k=6, layout="ep"))


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_head=16, d_ff=64, vocab=512,
                        moe=MoeConfig(num_experts=8, top_k=2, layout="ep"))
