"""Falcon-Mamba-7B — [arXiv:2410.05355; unverified]. Pure Mamba-1, 64
layers, d_inner = 2*4096 = 8192, ssm_state=16, attention-free."""
from .base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="mamba", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_head=128, d_ff=0, vocab=65024,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2))


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, vocab=512,
                        mamba=MambaConfig(d_state=4, d_conv=4, expand=2,
                                          chunk=16))
