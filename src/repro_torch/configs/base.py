"""Model configs and the architecture registry of the LM stack.

The counterpart of the reference's ``configs/base.py``, cut to what the
serving and scoring paths of the ten architectures read.  Each
architecture has a module ``configs/<id>.py`` exposing ``CONFIG`` (the
published configuration, value for value as in the reference) and
``smoke_config()`` (a reduced same-family config for CPU tests).  Dtypes
are torch dtypes.  ``RunConfig`` carries the trainer's knobs, field for
field as the reference's; ``ShapeConfig`` and ``input_specs`` come with
the pod-scale tools (ROADMAP A.11c).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["MoeConfig", "MambaConfig", "ModelConfig", "RunConfig",
           "REMAT_POLICIES", "ARCH_IDS", "PORTED_ARCHS",
           "get_config", "get_smoke_config"]


@dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # the reference's expert sharding ("ep" / "tp"); one card runs both
    # layouts the same way
    layout: str = "ep"
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    chunk: int = 128          # the reference's chunked-scan length (unused
    #                           here: the port's scan is one B7 launch)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | mamba | hybrid | encoder | vision
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0    # 0 = full attention; >0 = SWA window
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: MoeConfig | None = None
    moe_every: int = 1         # MoE replaces FFN every k-th layer (1 = all)
    mamba: MambaConfig | None = None
    block_pattern: Sequence[str] = ()
    # vision: cross-attention at position ``xattn_pos`` of every period of
    # ``xattn_period`` layers; image tokens come from a stub frontend
    xattn_period: int = 0
    xattn_pos: int = 3
    n_img_tokens: int = 0
    d_frontend: int = 0        # stub modality frontend embedding width
    modality: str = "text"     # text | audio_frames | image+text
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # attention chunking (chunked online softmax): 0 = auto
    q_chunk: int = 0
    kv_chunk: int = 0
    # sequence-chunked cross-entropy (never materializes (B,S,V) logits):
    # 0 = auto (chunk when S*V is large), -1 = disabled
    loss_chunk: int = 0

    # remat policy of the layer stack: none | dots | full
    remat: str = "full"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))

    @property
    def dt_rank(self) -> int:
        m = self.mamba or MambaConfig()
        return m.dt_rank or -(-self.d_model // 16)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: the stack's remat policies (``ModelConfig.remat``)
REMAT_POLICIES = ("none", "dots", "full")


@dataclass(frozen=True)
class RunConfig:
    """The trainer's knobs, the reference's ``RunConfig`` field for
    field.  On one card ``dp_reduce``, ``aer_*``, ``fsdp``,
    ``seq_parallel`` and ``rules_overrides`` are read by nothing: the
    reductions across cards and the sharding rules wait for ROADMAP
    A.11c, and with one device the reference ignores them too."""
    # gradient cross-replica reduction: psum | bidir_ring | ring | aer_topk
    dp_reduce: str = "psum"
    aer_frac: float = 0.02          # fraction shipped per step (aer_topk)
    aer_budget: int = 128
    fsdp: bool = True               # shard params over the data axis too
    seq_parallel: bool = False      # shard residual-stream seq over model
    rules_overrides: tuple = ()     # of (key, value) pairs
    grad_accum: int = 1
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 0       # 0 = off
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3


#: the reference's architectures (``repro.configs.base.ARCH_IDS``)
ARCH_IDS = [
    "minitron_8b", "granite_3_2b", "qwen3_14b", "granite_34b",
    "llama32_vision_11b", "hubert_xlarge", "mixtral_8x22b",
    "moonshot_v1_16b_a3b", "jamba_v01_52b", "falcon_mamba_7b",
]
#: the ones the port runs: all of them
PORTED_ARCHS = tuple(ARCH_IDS)


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; the reference "
                         f"has {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
