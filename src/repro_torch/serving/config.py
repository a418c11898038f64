"""`ServingConfig`: the engine's validated construction record (port of
`repro.serving.config`, cut to the port's path: the paged arena, FCFS,
synchronous chunked dispatch, int8 or int4-packed KV, and the
telemetry sink).

`kv_bits` is the KV storage width: 8 keeps the int8 KV images, 4 packs
two int4 nibbles per pool cell (half the pool bytes, per-kv-head
requant tables, lossy against int8 KV).  The reference also requires
the paged arena and the chunked prefill path for 4; the port's engine
has only those, so the one check left is the value
(`models.lm.check_kv_bits`, which `init_pools` applies too).

`device` places the KV pools and every dispatch; it defaults to
``"cuda"``.  Tables handed to the engine must already live there
(`models.lm.tables_from_numpy(..., device)`).

`telemetry` is the engine's observability sink
(`serving.telemetry.Telemetry`); None gives the no-op `NULL`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Optional

from repro_torch.models.lm import check_kv_bits
from repro_torch.serving.scheduler import SchedulerConfig

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.policy import SchedulingPolicy


@dataclasses.dataclass
class ServingConfig:
    n_slots: int = 8
    max_len: int = 256
    page_size: int = 16
    n_pages: Optional[int] = None  # None: n_slots * max_len positions
    scheduler: Optional[SchedulerConfig] = None
    policy: Optional["SchedulingPolicy"] = None  # None -> FCFSPolicy()
    device: str = "cuda"
    kv_bits: int = 8
    telemetry: Any = None  # None -> serving.telemetry.NULL

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        check_kv_bits(self.kv_bits)
        if self.n_pages is None:
            self.n_pages = -(-(self.n_slots * self.max_len) // self.page_size)
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.scheduler is None:
            self.scheduler = SchedulerConfig()
