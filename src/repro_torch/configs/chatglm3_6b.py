"""ChatGLM3-6B [dense; arXiv:2406.12793] — 2d RoPE (rotary on half the
head dim), near-MQA kv=2."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="chatglm3_6b", family="dense", n_layers=28, d_model=4096,
    vocab=65024, n_heads=32, n_kv_heads=2, head_dim=128, d_ff=13696,
    act="silu", gated=True, norm="rms", rope_fraction=0.5,
))
