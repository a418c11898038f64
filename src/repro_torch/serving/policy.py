"""Scheduling policy contract + FCFS (port of `repro.serving.policy`:
the `SchedulingPolicy` protocol, `EngineView`, `StepPlan` and
`FCFSPolicy`; framework-free).

The engine is pure mechanism: each step it builds a read-only
`EngineView` of host state, asks its policy for a `StepPlan` and
executes it (admit -> chunk rows -> decode).  `FCFSPolicy` is the
reference default: head-of-line FCFS admission up to
`max_prefills_per_step` gated by the arena's capacity, FIFO chunk
packing, decode every step, never a preemption.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.serving.request import Request

ChunkItem = Tuple[int, int]  # (req_id, n_tokens): one prefill-chunk row


@dataclasses.dataclass(frozen=True)
class PendingSnap:
    req: Request
    req_id: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    need_pages: int  # worst-case page commitment


@dataclasses.dataclass(frozen=True)
class PrefillSnap:
    req_id: int
    slot: int
    admit_time: float
    offset: int  # prompt tokens already written
    total: int  # prompt length


@dataclasses.dataclass(frozen=True)
class DecodeSnap:
    req_id: int
    slot: int
    first_token_time: float
    n_generated: int
    budget_left: int


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only per-step snapshot of host state."""

    now: float
    pending: Tuple[PendingSnap, ...]  # queue order
    prefilling: Tuple[PrefillSnap, ...]  # admission order
    active: Tuple[DecodeSnap, ...]  # slot order
    free_slots: int
    budget_left: int  # uncommitted pages
    prefill_chunk: int
    max_chunks_per_step: Optional[int]
    max_prefills_per_step: int


@dataclasses.dataclass
class StepPlan:
    """What the engine executes this step: `admit` these requests in
    order, run the `chunks` rows, and decode if `decode`.  `rejects`
    is accounting: (req_id, reason) of requests that did not fit."""

    admit: List[Request] = dataclasses.field(default_factory=list)
    chunks: List[ChunkItem] = dataclasses.field(default_factory=list)
    decode: bool = True
    rejects: List[Tuple[int, str]] = dataclasses.field(default_factory=list)


@runtime_checkable
class SchedulingPolicy(Protocol):
    name: str

    def plan(self, view: EngineView) -> StepPlan: ...


class AdmissionSim:
    """Mirror of the arena's admission ledger (free slots, page
    budget) through a plan's hypothetical admissions."""

    def __init__(self, view: EngineView):
        self.free_slots = view.free_slots
        self.budget = view.budget_left

    def admit(self, snap: PendingSnap) -> bool:
        if self.free_slots < 1 or snap.need_pages > self.budget:
            return False
        self.free_slots -= 1
        self.budget -= snap.need_pages
        return True

    def reject_reason(self) -> str:
        return "no_slot" if self.free_slots < 1 else "no_pages"


def _pack_chunks(rows: List[Tuple[int, int, int]], chunk: int,
                 cap: Optional[int]) -> List[ChunkItem]:
    """FIFO chunk packing over (req_id, offset, total) rows."""
    plan: List[ChunkItem] = []
    for req_id, offset, total in rows:
        if cap is not None and len(plan) >= cap:
            break
        n = min(chunk, total - offset)
        if n > 0:
            plan.append((req_id, n))
    return plan


class FCFSPolicy:
    name = "fcfs"

    def plan(self, view: EngineView) -> StepPlan:
        plan = StepPlan()
        sim = AdmissionSim(view)
        queue = list(view.pending)
        for _ in range(view.max_prefills_per_step):
            if not queue:
                break
            head = queue[0]
            if not sim.admit(head):
                # head-of-line backpressure: nothing younger overtakes
                plan.rejects.append((head.req_id, sim.reject_reason()))
                break
            plan.admit.append(queue.pop(0).req)
        rows = [(s.req_id, s.offset, s.total) for s in view.prefilling]
        admitted = {r.req_id for r in plan.admit}
        rows += [(p.req_id, 0, p.prompt_len) for p in view.pending
                 if p.req_id in admitted]
        plan.chunks = _pack_chunks(
            rows, view.prefill_chunk, view.max_chunks_per_step)
        return plan
