"""Granite-34B-Code — [arXiv:2405.04324]. Llama-arch, MQA (kv=1),
88 layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, act="silu")


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                        d_head=16, d_ff=128, vocab=512)
