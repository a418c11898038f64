"""Llama-4 Maverick 400B-A17B [moe; hf:meta-llama]: 128 experts top-1,
an expert layer in every other block (the "pair" segment: a dense
block, then a MoE block) and a shared expert beside the routed ones."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="llama4_maverick_400b_a17b", family="moe", n_layers=48,
    d_model=5120, vocab=202048, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, n_experts=128, top_k=1, moe_every=2, shared_expert=True,
    act="silu", gated=True, norm="rms", rope_base=500000.0,
))
