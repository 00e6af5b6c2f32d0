"""Jamba-v0.1 (52B total) — [arXiv:2403.19887]. Hybrid: 8-layer blocks with
attn:mamba 1:7 and MoE (16e top-2) every other layer; 4 blocks = 32 layers.
Pattern position 4 is the attention layer (middle of the block)."""
from .base import MambaConfig, ModelConfig, MoeConfig

_PATTERN = ("mamba_ffn", "mamba_moe", "mamba_ffn", "mamba_moe",
            "attn_ffn", "mamba_moe", "mamba_ffn", "mamba_moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, act="silu",
    block_pattern=_PATTERN,
    moe=MoeConfig(num_experts=16, top_k=2, layout="ep"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2))


def smoke_config():
    return CONFIG.with_(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512,
                        moe=MoeConfig(num_experts=4, top_k=2, layout="ep"),
                        mamba=MambaConfig(d_state=4, d_conv=4, expand=2,
                                          chunk=16))
