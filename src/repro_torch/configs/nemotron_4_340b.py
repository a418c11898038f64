"""Nemotron-4-340B [dense; arXiv:2402.16819] — LayerNorm with bias,
ungated squared-ReLU MLP (an exact integer square between two
requants, no LUT), GQA 96/8 at head_dim 192."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="nemotron_4_340b", family="dense", n_layers=96, d_model=18432,
    vocab=256000, n_heads=96, n_kv_heads=8, head_dim=192, d_ff=73728,
    act="relu2", gated=False, norm="layer", norm_bias=True,
))
