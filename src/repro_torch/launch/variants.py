"""Process-wide variant switches (port of `repro.launch.variants`,
with the keys a port path reads).

Layer code consults `get(key)` without plumbing; `use_variants(**kw)`
overrides keys for the duration of a `with` block, and the serving
engine runs each dispatch under `use_variants(paged_decode=...)`.
The reference's `kv_update` ("onehot" | "dus") and `kv_shard` ("seq"
| "batch") steer only XLA's lowering of the decode cache write and its
layout, which eager torch does not have: they are not keys here (the
float cache write is plain indexing, `layers.attention._cache_write`).

  attn_softmax  "float" (the paper's §3.8 float island) | "int" (the
                integer softmax, `core.intsoftmax`: no float
                operation left in attention)
  paged_decode  "kernel" (the paged attention kernel straight over the
                pools) | "gather" (write-then-gather: the dense
                logical view gathered through the table, the
                reference's parity oracle)
  ssm_island_dtype  "f32" (the scan island in float32) | "bf16" (the
                chunked scan in bfloat16 with a float32 carry,
                `layers.ssm._chunked`)
  ssm_chunk     the selective scan's chunk length (0: layers.ssm.CHUNK)
  serve_weight_stationary  False | True: the serve cells' weights
                replicated across "data" (no FSDP split of the tables;
                `launch.steps.serve_shardings`)
  train_zero2   False | True: the ZeRO-2 training layout, params
                replicated across "data", the Adam moments still 2-D
                sharded (`launch.steps.train_shardings`)
  microbatches  the gradient-accumulation factor of the cells (0: the
                `launch.steps.MICROBATCH` table's, else 1)

The attention takes the kernel only under "kernel" and the float
island; every other setting takes the gather path.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

_ACTIVE: Dict[str, Any] = {}

DEFAULTS = {
    "attn_softmax": "float",
    "paged_decode": "kernel",
    "ssm_island_dtype": "f32",
    "ssm_chunk": 0,
    "serve_weight_stationary": False,
    "train_zero2": False,
    "microbatches": 0,
}


def get(key: str):
    """The active value of `key` (KeyError for an unknown key)."""
    return _ACTIVE.get(key, DEFAULTS[key])


@contextlib.contextmanager
def use_variants(**kw):
    global _ACTIVE
    bad = set(kw) - set(DEFAULTS)
    if bad:
        raise KeyError(f"unknown variants: {bad}")
    prev = dict(_ACTIVE)
    _ACTIVE.update(kw)
    try:
        yield
    finally:
        _ACTIVE = prev


def parse(spec: str) -> dict:
    """'a=1,b=int' -> a dict typed by DEFAULTS."""
    out = {}
    if not spec:
        return out
    for item in spec.split(","):
        k, v = item.split("=")
        ref = DEFAULTS[k]
        if isinstance(ref, bool):
            out[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(ref, int):
            out[k] = int(v)
        else:
            out[k] = v
    return out
