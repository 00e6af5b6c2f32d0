"""HuBERT X-Large — [arXiv:2106.07447; unverified]. Encoder-only (bidir
attention, no decode shapes), GELU MLP, masked-prediction head over 504
cluster targets. Conv waveform frontend is a STUB (precomputed frames)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, act="gelu",
    causal=False, modality="audio_frames", d_frontend=1280)


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_head=16, d_ff=128, vocab=32, d_frontend=64)
