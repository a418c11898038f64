"""Scheduling policies (port of `repro.serving.policy`: the
`SchedulingPolicy` protocol, `EngineView`, `StepPlan`, `FCFSPolicy`,
`PrioritySLOPolicy` and the `make_policy` registry; framework-free).

The engine is pure mechanism: each step it builds a read-only
`EngineView` of host state, asks its policy for a `StepPlan` and
executes it (preempt -> admit -> chunk rows -> decode).  The snapshot
fields carry the reference's names, so one policy object plans for
either engine.

  `FCFSPolicy`: head-of-line FCFS admission up to
  `max_prefills_per_step` gated by the arena's capacity, FIFO chunk
  packing, decode every step, never a preemption.

  `PrioritySLOPolicy`: highest `Request.priority` first (FCFS within a
  class); a request that does not fit evicts strictly-lower-priority
  victims, lowest class and most recently admitted first, until it
  does, or rolls the evictions back and waits.  `slo_ttft_s` lets
  pending requests older than the target jump the order; eviction
  eligibility keeps the base priorities.  An evicted decode re-prefills
  `prompt + tokens[:-1]` and resumes bit-identically.

`AdmissionSim` mirrors the arena's (free slots, page budget) ledger
through a plan's hypothetical admissions and evictions, so a plan
never promises capacity the engine cannot deliver.
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
    priority: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    source_len: int  # prefill length (prompt, + generated on resume)
    # worst-case page commitment; with the prefix cache on, the
    # suffix-only charge (pages a registered prefix holds are charged
    # once, to the cache ledger)
    need_pages: int
    n_generated: int  # > 0: a preempted request awaiting resume


@dataclasses.dataclass(frozen=True)
class PrefillSnap:
    req_id: int
    slot: int
    priority: int
    arrival_time: float
    admit_time: float
    offset: int  # source tokens already written
    total: int  # source length
    is_resume: bool
    pages_committed: int  # handed back to the budget if evicted


@dataclasses.dataclass(frozen=True)
class DecodeSnap:
    req_id: int
    slot: int
    priority: int
    arrival_time: float
    admit_time: float
    first_token_time: float
    n_generated: int
    budget_left: int  # max_new_tokens - n_generated
    pages_committed: int  # handed back to the budget if evicted


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only per-step snapshot of host state.  `budget_left` leaves
    out the pages pinned by live prefix sharers and counts warm pages
    as available (lazily evictable)."""

    now: float
    pending: Tuple[PendingSnap, ...]  # queue order
    prefilling: Tuple[PrefillSnap, ...]  # admission order
    active: Tuple[DecodeSnap, ...]  # slot order
    free_slots: int
    budget_left: Optional[int]  # uncommitted pages (None: unpaged)
    gauges: dict  # the arena's instantaneous gauges
    prefill_mode: str  # "chunked" | "bucketed" | "exact"
    prefill_chunk: int
    max_chunks_per_step: Optional[int]
    max_prefills_per_step: int


@dataclasses.dataclass
class StepPlan:
    """What the engine executes this step, in order: evict the
    `preempt` slots, `admit` these requests, run the `chunks` rows, and
    decode if `decode`.  `rejects` is accounting: (req_id, reason) of
    requests that did not fit."""

    preempt: List[int] = dataclasses.field(default_factory=list)
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
    budget; None budget: slots are the only gate) through a plan's
    hypothetical admissions and evictions."""

    def __init__(self, view: EngineView):
        self.free_slots = view.free_slots
        self.budget = view.budget_left

    def fits(self, snap: PendingSnap) -> bool:
        if self.free_slots < 1:
            return False
        return self.budget is None or snap.need_pages <= self.budget

    def admit(self, snap: PendingSnap) -> bool:
        """Consume capacity for one admission if it fits."""
        if not self.fits(snap):
            return False
        self.free_slots -= 1
        if self.budget is not None:
            self.budget -= snap.need_pages
        return True

    def evict(self, victim):
        """Return a PrefillSnap's or DecodeSnap's capacity."""
        self.free_slots += 1
        if self.budget is not None:
            self.budget += victim.pages_committed

    def reject_reason(self, snap: PendingSnap) -> str:
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
                plan.rejects.append((head.req_id, sim.reject_reason(head)))
                break
            plan.admit.append(queue.pop(0).req)
        if view.prefill_mode == "chunked":
            rows = [(s.req_id, s.offset, s.total) for s in view.prefilling]
            admitted = {r.req_id for r in plan.admit}
            rows += [(p.req_id, 0, p.source_len) for p in view.pending
                     if p.req_id in admitted]
            plan.chunks = _pack_chunks(
                rows, view.prefill_chunk, view.max_chunks_per_step)
        return plan


class PrioritySLOPolicy:
    """Priority classes with preemption (see the module docstring)."""

    name = "priority"

    def __init__(self, *, preempt: bool = True,
                 slo_ttft_s: Optional[float] = None):
        self.preempt = bool(preempt)
        self.slo_ttft_s = slo_ttft_s

    def _order(self, view: EngineView) -> List[PendingSnap]:
        def key(p: PendingSnap):
            aged = (self.slo_ttft_s is not None
                    and (view.now - p.arrival_time) >= self.slo_ttft_s)
            return (0 if aged else 1, -p.priority, p.arrival_time)

        return sorted(view.pending, key=key)

    def plan(self, view: EngineView) -> StepPlan:
        plan = StepPlan()
        sim = AdmissionSim(view)
        # cheapest eviction first: lowest class, then most recently
        # admitted (the least sunk work)
        victims = sorted(list(view.prefilling) + list(view.active),
                         key=lambda v: (v.priority, -v.admit_time))
        evicted: set = set()
        for cand in self._order(view):
            if len(plan.admit) >= view.max_prefills_per_step:
                break
            if sim.admit(cand):
                plan.admit.append(cand.req)
                continue
            if not self.preempt:
                plan.rejects.append((cand.req_id, sim.reject_reason(cand)))
                continue
            chosen = []
            saved = (sim.free_slots, sim.budget)
            for v in victims:
                if v.slot in evicted or v.priority >= cand.priority:
                    continue
                chosen.append(v)
                sim.evict(v)
                if sim.fits(cand):
                    break
            if sim.admit(cand):
                evicted.update(v.slot for v in chosen)
                plan.preempt.extend(v.slot for v in chosen)
                plan.admit.append(cand.req)
            else:
                # no strictly-lower-priority victim set frees enough:
                # roll the hypothetical evictions back
                sim.free_slots, sim.budget = saved
                plan.rejects.append((cand.req_id, sim.reject_reason(cand)))
        if view.prefill_mode == "chunked":
            live = sorted(
                (s for s in view.prefilling if s.slot not in evicted),
                key=lambda s: (-s.priority, s.admit_time))
            rows = [(s.req_id, s.offset, s.total) for s in live]
            admitted = {r.req_id for r in plan.admit}
            rows += [(p.req_id, 0, p.source_len) for p in self._order(view)
                     if p.req_id in admitted]
            plan.chunks = _pack_chunks(
                rows, view.prefill_chunk, view.max_chunks_per_step)
        return plan


# the CLI registry (launch/serve.py --policy)
POLICIES = {"fcfs": FCFSPolicy, "priority": PrioritySLOPolicy}


def make_policy(name: str, **kwargs) -> SchedulingPolicy:
    """Build a policy by registry name."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r} (have: {sorted(POLICIES)})") from None
    return cls(**kwargs)
