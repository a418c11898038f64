"""MusicGen-medium [audio; arXiv:2306.05284] — decoder-only transformer
over EnCodec tokens (delay pattern flattened to one stream, the EnCodec
frontend left out as in the reference); LayerNorm with bias, ungated
GELU MLP, MHA (24 kv heads)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="musicgen_medium", family="dense", n_layers=48, d_model=1536,
    vocab=2048, n_heads=24, n_kv_heads=24, head_dim=64, d_ff=6144,
    act="gelu", gated=False, norm="layer", norm_bias=True,
))
