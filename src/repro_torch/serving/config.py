"""`ServingConfig`: the engine's validated construction record (port of
`repro.serving.config`, cut to this slice's path: the paged arena, FCFS,
synchronous chunked dispatch, int8 KV).

`device` places the KV pools and every dispatch; it defaults to
``"cuda"``.  Tables handed to the engine must already live there
(`models.lm.tables_from_numpy(..., device)`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

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

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages is None:
            self.n_pages = -(-(self.n_slots * self.max_len) // self.page_size)
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.scheduler is None:
            self.scheduler = SchedulerConfig()
