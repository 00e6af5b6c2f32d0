"""Model configs and the architecture registry of the LM stack.

The counterpart of the reference's ``configs/base.py``, cut to what the
serving and scoring paths of the ten architectures read.  Each
architecture has a module ``configs/<id>.py`` exposing ``CONFIG`` (the
published configuration, value for value as in the reference) and
``smoke_config()`` (a reduced same-family config for CPU tests).  Dtypes
are torch dtypes.  ``RunConfig`` carries the trainer's knobs, field for
field as the reference's.  ``ShapeConfig``, the four shape sets, their
skip rules (``shapes_for``) and ``input_specs`` are the reference's too:
``input_specs`` builds the batch of an (arch x shape) cell as tensors on
the ``meta`` device by default (shapes and dtypes, no storage), which is
what the dry-run traces.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["MoeConfig", "MambaConfig", "ModelConfig", "RunConfig",
           "REMAT_POLICIES", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "ALL_SHAPES", "shapes_for",
           "input_specs", "ARCH_IDS", "PORTED_ARCHS",
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
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                  LONG_500K)}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The reference's skip rules: encoder-only archs have no decode
    shapes; ``long_500k`` needs a sub-quadratic path (SSM, hybrid or a
    sliding window)."""
    out = [TRAIN_4K, PREFILL_32K]
    if cfg.causal:
        out.append(DECODE_32K)
        if cfg.family in ("mamba", "hybrid") or cfg.sliding_window > 0:
            out.append(LONG_500K)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """The batch of an (arch x shape) cell, the reference's keys, shapes
    and dtypes, as uninitialised tensors on ``device`` (``meta`` by
    default: no storage).  Train and prefill take int32 ``tokens`` and
    ``labels`` (B, S), or float32 ``frames`` (B, S, d_frontend) with
    int32 ``labels`` and ``mask`` for audio; decode takes one int32
    token (B, 1) and its position (B,); an image model adds float32
    ``img_embed`` (B, n_img_tokens, d_frontend) to either."""
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32

    def t(size, dtype):
        return torch.empty(size, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        if cfg.modality == "audio_frames":
            specs = {"frames": t((b, s, cfg.d_frontend), f32),
                     "labels": t((b, s), i32), "mask": t((b, s), i32)}
        else:
            specs = {"tokens": t((b, s), i32), "labels": t((b, s), i32)}
    else:
        specs = {"tokens": t((b, 1), i32), "pos": t((b,), i32)}
    if cfg.modality == "image+text":
        specs["img_embed"] = t((b, cfg.n_img_tokens, cfg.d_frontend), f32)
    return specs


@dataclass(frozen=True)
class RunConfig:
    """The trainer's knobs, the reference's ``RunConfig`` field for
    field.  ``dp_reduce`` and ``aer_*`` are read by the data-parallel
    step (with one device and no rules the reference ignores them too);
    ``fsdp``, ``seq_parallel`` and ``rules_overrides`` build the
    sharding rules of the launcher and the dry-run."""
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
