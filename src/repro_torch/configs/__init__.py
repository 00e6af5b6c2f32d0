"""Architecture configs of the LM stack: so far the Mamba family
(``falcon_mamba_7b``); the other architectures come with ROADMAP A.11."""
from .base import (ARCH_IDS, MambaConfig, ModelConfig,  # noqa: F401
                   get_config, get_smoke_config)
