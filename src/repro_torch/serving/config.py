"""`ServingConfig`: the engine's validated construction record (port of
`repro.serving.config`: the arena (`paged`), a scheduling policy,
dispatch synchronous or one step deep (`dispatch_depth` 0 or 1), int8
or int4-packed KV, the prefix cache, the telemetry sink, and the
serving mesh).

`paged` picks the arena, as in the reference, whose default it keeps:
False is `SlotArena` (every slot leases `max_len` contiguous
positions), True is `PagedArena` (`page_size`, `n_pages`: a pool of
pages leased on demand against a per-request budget).

`kv_bits` is the KV storage width: 8 keeps the int8 KV images, 4 packs
two int4 nibbles per pool cell (half the pool bytes, per-kv-head
requant tables, lossy against int8 KV).  4 needs the paged arena (and
the engine, the chunked prefill path).

`device` places the KV pools and every dispatch; it defaults to
``"cuda"``.  Tables handed to the engine must already live there
(`models.lm.tables_from_numpy(..., device)`).

`prefix_cache` turns on refcounted page sharing across requests
(a content-keyed trie of full pages, suffix-only admission,
copy-on-write); `cache_keep_pages` is its warm-page budget: registered
pages kept resident (refcount 0, evicted LRU on demand) after their
last holder releases them, so a later shared-prefix admission or a
preemption's resume reuses them without recompute (0: evict at once).
Both need the paged arena (and the engine, the chunked prefill path).

`paged_kernel` picks the attention's path: None or True keep the
paged attention kernel (over either arena: the slot arena is stored
as pages), False takes the write-then-gather path, the reference's
parity oracle (`launch.variants` ``paged_decode="gather"``).  Under
``attn_softmax="int"`` every path is the gather path, whatever this
says.  The reference's engine takes `paged_kernel and paged`, since
its slot arena has no kernel path; the port's has one, so only False
leaves the kernel.

`dispatch_depth` is the engine's pipeline depth: 0 harvests every
step before the next is planned; 1 leaves one step in flight on the
device while the host plans the next (`engine.DispatchQueue`).

`telemetry` is the engine's observability sink
(`serving.telemetry.Telemetry`); None gives the no-op `NULL`.

`mesh` is the serving mesh (`launch.mesh.make_serving_mesh`: a
DeviceMesh with a "model" dim, one process a rank) and `kv_shard`
splits the KV arena's kv-head axis over its "model" dim
(`sharding.rules`); `kv_shard` needs a mesh.  With a mesh and without
`kv_shard` every rank holds the whole arena (the reference's
mesh-but-unsharded point).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

from repro_torch.models.lm import check_kv_bits
from repro_torch.serving.scheduler import SchedulerConfig

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.policy import SchedulingPolicy


def check_dispatch_depth(depth: int) -> int:
    """0 (synchronous) or 1 (one step in flight): step t+1's input is
    step t's argmax, so no deeper pipeline is exact."""
    if depth not in (0, 1):
        raise ValueError(
            "dispatch_depth must be 0 (synchronous) or 1 (the "
            "autoregressive token feedback bounds the pipeline at "
            f"one in-flight step), got {depth}")
    return depth


@dataclasses.dataclass
class ServingConfig:
    n_slots: int = 8
    max_len: int = 256
    paged: bool = False
    page_size: int = 16
    n_pages: Optional[int] = None  # None: n_slots * max_len positions
    paged_kernel: Optional[bool] = None  # False: the write-then-gather path
    scheduler: Optional[SchedulerConfig] = None
    policy: Optional["SchedulingPolicy"] = None  # None -> FCFSPolicy()
    device: str = "cuda"
    kv_bits: int = 8
    dispatch_depth: int = 0  # 0 synchronous, 1 one step in flight
    telemetry: Any = None  # None -> serving.telemetry.NULL
    prefix_cache: bool = False
    cache_keep_pages: int = 0  # warm-page budget (needs prefix_cache)
    mesh: Any = None  # launch.mesh.make_serving_mesh
    kv_shard: bool = False  # kv heads split over the mesh's "model" dim

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        check_kv_bits(self.kv_bits)
        check_dispatch_depth(self.dispatch_depth)
        if self.kv_bits == 4 and not self.paged:
            raise ValueError("kv_bits=4 needs the paged arena (paged=True): "
                             "nibble packing is a page-pool layout")
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True needs the paged arena "
                             "(paged=True): sharing is page-granular")
        if self.n_pages is None:
            self.n_pages = -(-(self.n_slots * self.max_len) // self.page_size)
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.cache_keep_pages < 0:
            raise ValueError("cache_keep_pages must be >= 0, "
                             f"got {self.cache_keep_pages}")
        if self.cache_keep_pages and not self.prefix_cache:
            raise ValueError("cache_keep_pages needs prefix_cache=True "
                             "(warm pages are prefix-cache state)")
        if self.kv_shard and self.mesh is None:
            raise ValueError("kv_shard=True needs a mesh "
                             "(launch.mesh.make_serving_mesh)")
        if self.mesh is not None and "model" not in (
                self.mesh.mesh_dim_names or ()):
            raise ValueError('serving mesh needs a "model" dim, got '
                             f"{self.mesh.mesh_dim_names}")
        if self.scheduler is None:
            self.scheduler = SchedulerConfig()
