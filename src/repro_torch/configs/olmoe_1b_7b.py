"""OLMoE-1B-7B [moe; arXiv:2409.02060]: 64 experts, top-8,
d_ff=1024/expert."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="olmoe_1b_7b", family="moe", n_layers=16, d_model=2048,
    vocab=50304, n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024,
    n_experts=64, top_k=8, moe_every=1, act="silu", gated=True, norm="rms",
))
