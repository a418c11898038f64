"""Llama-3.2-3B [dense; hf:meta-llama]."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="llama3_2_3b", family="dense", n_layers=28, d_model=3072,
    vocab=128256, n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192,
    act="silu", gated=True, norm="rms", rope_base=500000.0,
))
