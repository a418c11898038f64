"""Architecture registry (the configs of `configs.base.ARCH_IDS`)."""
from repro_torch.configs.base import (
    ARCH_IDS, LM_ARCH_IDS, SERVE_ARCH_IDS, ArchConfig, get_config,
)
