"""Architecture registry (the dense configs the port serves: granite_3_2b,
llama3_2_3b, chatglm3_6b)."""
from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
