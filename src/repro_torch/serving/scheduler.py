"""Admission queue and prompt-shape bucketing (port of
`repro.serving.scheduler`).

The decisions live in the policy (serving/policy.py); this module is
the FIFO queue mechanism the engine manipulates, the per-step shape
knobs (`SchedulerConfig`) and `bucket_len`.

`prefill_chunk` > 0 (dense family) is the chunked path; 0 is the
whole-prompt path, where a prompt is prefilled at once at batch 1,
right-padded to the next multiple of `prefill_bucket` ("bucketed",
dense) or at its exact length ("exact": the engine forces it for MoE,
whose capacity routing integrates every position).  Padding is exact
for the causally masked dense prefill: the padded positions sit after
the true last token and the first decode writes over them.  The reference's `Scheduler.plan_chunks` is
not ported: the reference keeps it as legacy and its engine never
calls it; the same FIFO packing (the next `prefill_chunk` tokens of
every prefilling request, in admission order, capped at
`max_chunks_per_step` rows) is `FCFSPolicy`'s, which the engine runs.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_prefills_per_step: int = 2  # admission cap per engine step
    prefill_bucket: int = 16  # whole-prompt shape bucket
    # tokens per prefill chunk; 0: the whole-prompt path
    prefill_chunk: int = 32
    max_chunks_per_step: Optional[int] = None  # chunk rows per dispatch


class Scheduler:
    """FIFO admission queue."""

    def __init__(self, cfg: SchedulerConfig, max_len: int):
        if cfg.prefill_bucket < 1:
            raise ValueError(
                f"prefill_bucket must be >= 1, got {cfg.prefill_bucket}")
        if cfg.max_prefills_per_step < 1:
            raise ValueError(
                "max_prefills_per_step must be >= 1, "
                f"got {cfg.max_prefills_per_step}")
        if cfg.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {cfg.prefill_chunk}")
        if (cfg.max_chunks_per_step is not None
                and cfg.max_chunks_per_step < 1):
            raise ValueError(
                "max_chunks_per_step must be >= 1, "
                f"got {cfg.max_chunks_per_step}")
        self.cfg = cfg
        self.max_len = max_len
        self.pending: Deque[Request] = collections.deque()

    def submit(self, req: Request):
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {req.prompt_len + req.max_new_tokens} "
                f"positions but the arena holds {self.max_len}")
        self.pending.append(req)

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    def requeue(self, req: Request):
        """Put a request back at the queue head."""
        self.pending.appendleft(req)

    def take(self, req: Request) -> bool:
        """Remove a specific request (matched by identity)."""
        for i, queued in enumerate(self.pending):
            if queued is req:
                del self.pending[i]
                return True
        return False

    def bucket_len(self, prompt_len: int) -> int:
        """Padded prefill length for a prompt: the next bucket multiple,
        capped at the arena's sequence capacity."""
        b = self.cfg.prefill_bucket
        return min(-(-prompt_len // b) * b, self.max_len)
