"""Architecture registry (the configs the port serves: granite_3_2b,
llama3_2_3b, chatglm3_6b, musicgen_medium, nemotron_4_340b and
olmoe_1b_7b, and the CNN nemo_cnn)."""
from repro_torch.configs.base import (
    ARCH_IDS, LM_ARCH_IDS, ArchConfig, get_config,
)
