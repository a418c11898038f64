"""Serving-arena sharding (port of `repro.sharding`'s arena half)."""
from repro_torch.sharding.hints import profile_mesh, use_profile
from repro_torch.sharding.rules import (
    arena_leaf_spec, arena_shardings, cache_spec, kv_head_axis,
    kv_head_range, model_coords, sanitize_spec,
)

__all__ = [
    "arena_leaf_spec", "arena_shardings", "cache_spec", "kv_head_axis",
    "kv_head_range", "model_coords", "profile_mesh", "sanitize_spec",
    "use_profile",
]
