"""Architecture registry (dense serving slice: granite_3_2b)."""
from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
