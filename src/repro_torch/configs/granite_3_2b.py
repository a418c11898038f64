"""Granite-3.0-2B [dense; hf:ibm-granite] — GQA kv=8."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="granite_3_2b", family="dense", n_layers=40, d_model=2048,
    vocab=49155, n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
    act="silu", gated=True, norm="rms",
))
