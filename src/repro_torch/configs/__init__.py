"""Architecture configs of the LM stack: the Mamba family
(``falcon_mamba_7b``), the dense family (``granite_3_2b``,
``qwen3_14b``, ``minitron_8b``, ``granite_34b``) and the MoE family
(``mixtral_8x22b``, ``moonshot_v1_16b_a3b``); the hybrid,
cross-attention and encoder architectures come with ROADMAP A.11."""
from .base import (ARCH_IDS, MambaConfig, ModelConfig,  # noqa: F401
                   MoeConfig, get_config, get_smoke_config)
