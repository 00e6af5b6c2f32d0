"""Granite-3.0-2B base — [hf:ibm-granite/granite-3.0-2b-base].
Dense, GQA kv=8, SwiGLU."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, act="silu")


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512)
