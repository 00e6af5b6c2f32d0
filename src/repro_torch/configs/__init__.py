"""Architecture configs of the LM stack, all ten of the reference's: the
Mamba family (``falcon_mamba_7b``), the dense family (``granite_3_2b``,
``qwen3_14b``, ``minitron_8b``, ``granite_34b``), the MoE family
(``mixtral_8x22b``, ``moonshot_v1_16b_a3b``), the hybrid
(``jamba_v01_52b``), the vision decoder (``llama32_vision_11b``) and the
audio encoder (``hubert_xlarge``)."""
from .base import (ARCH_IDS, MambaConfig, ModelConfig,  # noqa: F401
                   MoeConfig, get_config, get_smoke_config)
