"""Zamba2-1.2B [hybrid; arXiv:2411.15242]: a Mamba-2 backbone with one
shared full-attention block applied every 6 Mamba-2 blocks over
concat(x, x0) (the reference's values)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="zamba2_1_2b", family="hybrid", n_layers=38, d_model=2048,
    vocab=32000, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, ssm_kind="mamba2", ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, shared_attn_every=6, norm="rms", sub_quadratic=True,
    notes="shared-attn weights single-copy in FP/FQ; per-application "
    "integer tables in ID (quanta differ per application)",
))
