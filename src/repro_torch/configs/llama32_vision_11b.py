"""Llama-3.2-11B-Vision — [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
Text decoder with gated cross-attention layers every 5th position; vision
frontend is a STUB (precomputed patch embeddings, width 1280)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama32-vision-11b", family="vision", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, act="silu",
    xattn_period=5, xattn_pos=3, n_img_tokens=1600, d_frontend=1280,
    modality="image+text")


def smoke_config():
    return CONFIG.with_(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512, n_img_tokens=8,
                        d_frontend=32)
