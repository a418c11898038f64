"""Falcon-Mamba-7B [ssm; arXiv:2410.05355]: attention-free, 64 Mamba-1
blocks."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="falcon_mamba_7b", family="ssm", n_layers=64, d_model=4096,
    vocab=65024, d_ff=0, ssm_kind="mamba1", ssm_state=16, ssm_expand=2,
    norm="rms", sub_quadratic=True,
    notes="selective-scan core is a §3.8 float island; projections W8A8",
))
