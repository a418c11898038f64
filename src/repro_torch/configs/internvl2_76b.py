"""InternVL2-76B [vlm; arXiv:2404.16821] — InternViT frontend stubbed:
the model takes precomputed embeddings (input_mode "embeds") into an
InternLM2-72B-class decoder backbone."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="internvl2_76b", family="dense", n_layers=80, d_model=8192,
    vocab=128256, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
    act="silu", gated=True, norm="rms", input_mode="embeds",
    notes="ViT frontend stub; backbone-only per assignment",
))
