"""The serving mesh profile (port of `repro.sharding.hints`'s
mechanism: `use_profile`, `profile_mesh`).

The engine enters `use_profile(mesh)` around each dispatch of a
kv-sharded arena; the layer code that computes a per-shard head range
(`layers.attention.QAttention.apply_id`) reads the mesh here instead of
growing a mesh parameter through every signature.

The reference's `hint(x, kind)` has no counterpart here.  Its layers
pin GSPMD layouts with `with_sharding_constraint` and let the compiler
move data; the port's ranks compute their head range explicitly
(`sharding.rules.kv_head_range`) and exchange the int8 ctx rows with
one collective, so nothing is left to constrain.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def profile_mesh():
    """The active profile's mesh (None outside a profile)."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_profile(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev

