"""`ServingEngine`: continuous batching over the integer-only model
(port of `repro.serving.engine.ServingEngine`: steps over either arena
(`ServingConfig.paged`), synchronous or one step deep
(`ServingConfig.dispatch_depth`), the three prefill modes, int8 or
int4-packed KV (`ServingConfig.kv_bits`), a scheduling policy with
preemption, the prefix cache, telemetry).

The prefill dispatch is decided in one place, `_prefill_mode`:
"chunked" (dense family, `prefill_chunk` > 0, the default), "bucketed"
(dense, `prefill_chunk` 0: the whole prompt at batch 1, right-padded to
a `prefill_bucket` multiple) or "exact" (MoE and ssm: the whole prompt
at its exact length, since capacity routing and the recurrent conv /
scan state integrate every position, so neither padding nor a chunk's
garbage rows are admissible).  kv_bits 4
and the prefix cache need the chunked mode.

Chunked mode.  Each `step()`:

  1. samples a read-only `EngineView` and asks the policy for a
     `StepPlan`;
  2. preempts the planned slots: releases their pages and lease, parks
     a decode's progress in a host-side `ResumeState` and requeues the
     request at the queue head;
  3. admits the planned requests (lease a slot, commit the page
     budget; with the prefix cache, install the longest registered
     prefix of the source and start the chunk cursor past it);
  4. issues ONE unified dispatch of `DecoderLM.prefill_chunk` over
     every arena row: decode rows carry their last token as a width-1
     chunk at their decode position, prefill rows carry the next chunk
     of their prompt at their offset, everything else parks at
     INACTIVE_POS.  The dispatch width is the chunk width C when any
     prefill row rides along and 1 otherwise, so exactly two shapes
     exist, (n_slots, C) and (n_slots, 1), both run by `warmup()`;
  5. takes each row's next token by greedy argmax on the device over
     the int32 logits (first index on ties, like `jnp.argmax`) and
     harvests the (n_slots,) token vector, the step's one host sync.
     With the prefix cache on, every page a chunk or a decode just
     filled is registered.

Async dispatch (`dispatch_depth=1`, the `DispatchQueue`): a one step
deep pipeline.  While step t's dispatch runs on the device, the host
already plans step t+1 (policy, preemption, admission); then it
harvests step t, materializes the chunk rows and dispatches step t+1,
which stays in flight.  The harvest precedes the next dispatch because
that dispatch's decode rows need step t's tokens and the chunk cursors
advance at harvest: the token feedback bounds the pipeline at one step
in flight.  A plan that preempts first drains the in-flight step (the
victim's token from it is real output), then evicts.  Depth 1 gives
depth 0's tokens request by request; a request's timing may shift by
a step (admission sees slot releases one harvest later).  On the card
the dispatch enqueues the token vector's copy into pinned host memory
and records a CUDA event; the harvest waits on that event, the one
point where a step waits for the device (every host-to-device copy of
a step is non-blocking from pinned memory).

Preemption is exact: a preempted decode re-prefills `prompt +
tokens[:-1]` and resumes from `tokens[-1]` without emitting anything;
the re-prefill's last row must regenerate `tokens[-1]`, else
`_resume_decoding` raises (the resume-parity oracle).  With the prefix
cache on and a warm-page budget, the victim's registered pages stay
warm through its release, so the resume re-prefills at most the
unregistered tail.  A copy-on-write split happens in the `touch` loop
of the dispatch, before the step's `prefill_chunk` is enqueued.

Whole-prompt modes (bucketed, exact): admission prefills the source at
batch 1 into a scratch cache of one slot (`DecoderLM.prefill` over
`init_caches(1, max_len)`), reads the first token at the true last
position, and scatters the scratch row into the slot (`write_slot`);
each step then issues one fused decode (`decode_step`) over every slot
row, rows without an active decode parked at INACTIVE_POS with token
0.  Under MoE those parked rows route and compete for expert capacity,
as the reference's do.  The decode's token vector is harvested as the
chunked step's is (depth 1 leaves it in flight); a resumed request
re-prefills prompt + tokens[:-1] at admission and must regenerate
tokens[-1].

Telemetry (`ServingConfig.telemetry`, DESIGN.md §Observability): the
engine threads an off-by-default, bit-neutral sink through every
lifecycle transition (the reference's trace events), every step phase
(spans `admission`, `plan_chunks`, `unified_dispatch`, and in the
whole-prompt modes `decode_dispatch`, then `harvest`) and
every dispatch (shape counters, and `torch.profiler.record_function`
ranges when `profile_annotations` is on).  The hooks read host state
only, so telemetry cannot change a token.  On the card the kernels run
asynchronously to the host, so `unified_dispatch` times the host's
work to build and enqueue a step (Python, torch dispatch and kernel
launches) and `harvest` times the wait for the device to finish it
(the token copy's event) plus the host bookkeeping after it; at depth
1 the `admission` span runs while the previous step is on the device,
and `harvest` waits only for what of it is left.  Per-token
emit stamps always accrue on the completions, and `stats()` rolls
them up into TTFT / ITL percentiles and the queued / prefill / decode
breakdown.

Attention path (`ServingConfig.paged_kernel`): every dispatch (the
unified step, the fused decode, the whole-prompt prefill) runs under
`launch.variants.use_variants(paged_decode=...)`, "kernel" unless
`paged_kernel` is False, which takes the write-then-gather path; the
caller's own `use_variants(attn_softmax="int")` around the engine's
steps selects the integer softmax (always on the gather path), as in
the reference, where it is not an engine field either.  The
constructor checks that the arena's caches hold no float tensor
(`serving.cache.assert_integer_caches`).

Multi-device (`ServingConfig.mesh`, `kv_shard`; the reference's
DESIGN.md §Serving ¶Multi-device): one process a rank, each running
this engine with the same host scheduler on the same replicated
tables.  With `kv_shard` each rank's arena holds its contiguous kv
heads (`serving.cache.make_arena`), the engine cuts the layers' `kv4`
tables to them once (`models.lm.shard_tables`), and every dispatch
runs under the mesh's profile (`sharding.hints.use_profile`), in which
the attention computes those heads and all-gathers the int8 ctx rows
before wo (`layers.attention`), so every rank gets the single-device
engine's tokens, step for step, at either dispatch depth.  Only rank 0 calls
`on_token`.  `stats()` reports `mesh_devices` and `kv_shard` as the
reference's does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import variants
from repro_torch.layers.attention import INACTIVE_POS
from repro_torch.models.lm import shard_tables
from repro_torch.serving.cache import assert_integer_caches, make_arena
from repro_torch.serving.config import ServingConfig, check_dispatch_depth
from repro_torch.serving.policy import (
    DecodeSnap, EngineView, FCFSPolicy, PendingSnap, PrefillSnap, StepPlan,
)
from repro_torch.serving.request import (
    FINISH_LENGTH, FINISH_MAX_LEN, FINISH_STOP, Completion, PrefillState,
    Request, RequestState, ResumeState,
)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.sharding.hints import use_profile
from repro_torch.serving.telemetry import NULL

ChunkRow = Tuple[PrefillState, int, int]  # (state, offset, n_tokens)


@dataclasses.dataclass
class _InFlightStep:
    """One dispatched-but-unharvested step: a unified step, or the
    whole-prompt modes' decode (no chunk rows)."""

    # (n_slots,) per-row argmax on the device, held until the harvest
    tokens: torch.Tensor
    host: torch.Tensor  # its host copy (pinned, in flight on the card)
    done: Any  # the copy's CUDA event on the card; None on the CPU
    chunk_plan: List[ChunkRow]  # the chunk rows dispatched
    decode_slots: List[int]  # the slots decoded by this dispatch


class DispatchQueue:
    """The host / device pipeline of the engine's step dispatches.

    depth 0: synchronous, every dispatch harvested in its own engine
    step (the token-parity oracle for depth 1).  depth 1: one step left
    in flight while the next step's host work runs.  Deeper pipelines
    are refused: step t+1's input is step t's argmax, so a second step
    in flight would have to guess tokens."""

    def __init__(self, depth: int = 0):
        check_dispatch_depth(depth)
        self.depth = depth
        self._inflight: Deque[Any] = collections.deque()

    @property
    def pending(self) -> int:
        return len(self._inflight)

    def push(self, rec):
        if len(self._inflight) >= max(self.depth, 1):
            raise RuntimeError("dispatch queue overfilled")
        self._inflight.append(rec)

    def drain(self, harvest: Callable[[Any], None]):
        """Harvest every in-flight record (oldest first)."""
        while self._inflight:
            harvest(self._inflight.popleft())


class ServingEngine:
    def __init__(self, lm, tables, config: Optional[ServingConfig] = None,
                 *, on_token: Optional[Callable[[int, int], None]] = None):
        cfg = self.config = config if config is not None else ServingConfig()
        if lm.cfg.input_mode != "tokens":
            raise ValueError(
                "ServingEngine serves token LMs "
                f"(input_mode={lm.cfg.input_mode!r})")
        self.lm = lm
        self.device = torch.device(cfg.device)
        self.mesh = cfg.mesh
        self.kv_shard = bool(cfg.kv_shard)
        self.policy = cfg.policy if cfg.policy is not None else FCFSPolicy()
        self.arena = make_arena(lm, cfg)
        # a kv-sharded rank's kv4 tables hold its heads, cut once here
        self.tables = (tables if self.arena.kv_range is None
                       else shard_tables(tables, self.arena.kv_range))
        assert_integer_caches(
            self.arena.caches,
            allow_ssm_state=lm.cfg.family in ("ssm", "hybrid"))
        self.paged_kernel = cfg.paged_kernel is None or bool(cfg.paged_kernel)
        self._paged_decode = "kernel" if self.paged_kernel else "gather"
        self.sched = Scheduler(cfg.scheduler, cfg.max_len)
        # THE prefill dispatch decision (see the module docstring)
        if lm.cfg.family != "dense":
            self._prefill_mode = "exact"
        elif self.sched.cfg.prefill_chunk > 0:
            self._prefill_mode = "chunked"
        else:
            self._prefill_mode = "bucketed"
        if cfg.kv_bits == 4 and self._prefill_mode != "chunked":
            raise ValueError(
                "kv_bits=4 requires the chunked prefill path "
                "(prefill_chunk > 0, dense family); this engine is in "
                f"{self._prefill_mode!r} mode")
        if cfg.prefix_cache and self._prefill_mode != "chunked":
            raise ValueError(
                "prefix_cache=True requires the chunked prefill path "
                "(prefill_chunk > 0, dense family); this engine is in "
                f"{self._prefill_mode!r} mode")
        self._scratch = None  # the whole-prompt prefill's B=1 cache
        self.queue = DispatchQueue(cfg.dispatch_depth)
        # every rank emits the same tokens; rank 0 reports them
        self.on_token = (on_token if self.mesh is None
                         or torch.distributed.get_rank() == 0 else None)
        self.tel = cfg.telemetry if cfg.telemetry is not None else NULL
        self.active: Dict[int, RequestState] = {}  # slot -> decode state
        # slot -> chunked-prefill progress, in admission order
        self.prefilling: Dict[int, PrefillState] = {}
        self.completed: List[Completion] = []
        # req_id -> decode progress parked by a preemption, waiting in
        # the queue for re-admission
        self._resume: Dict[int, ResumeState] = {}
        self._prefix_on = bool(cfg.prefix_cache)
        if self._prefix_on:
            self.arena.on_cow = self._on_cow
        self._next_id = 0
        self._steps = 0
        self._n_generated = 0
        self._n_admit_rejects = 0
        self._n_preempts = 0
        self._occupancy_sum = 0.0
        self._max_active = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- submission -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               stop_token: Optional[int] = None, priority: int = 0) -> int:
        """Enqueue a request; returns its req_id.  `priority` is a
        policy hint (FCFS ignores it)."""
        req = (prompt if isinstance(prompt, Request)
               else Request(prompt, max_new_tokens, stop_token, priority))
        self.arena.check_request(
            req.prompt_len, req.prompt_len + req.max_new_tokens)
        # the id is spent before the scheduler may refuse the request,
        # as in the reference engine
        req.req_id = self._next_id
        self._next_id += 1
        req.arrival_time = time.perf_counter()
        self.sched.submit(req)
        if self.tel.enabled:
            self.tel.event("submit", req_id=req.req_id,
                           prompt_len=req.prompt_len,
                           max_new_tokens=req.max_new_tokens)
        return req.req_id

    # -- one engine step ------------------------------------------------
    def step(self) -> bool:
        """Plan, admit, dispatch and harvest once.  False when idle.
        With `dispatch_depth=1` the step dispatched here is harvested
        by the NEXT step."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        if self.queue.depth > 0:
            return self._step_async()
        return self._step_sync()

    def _step_sync(self) -> bool:
        """The synchronous step (depth 0): its dispatch is harvested
        before it returns.  Telemetry spans time each phase; with the
        Null sink each span is a shared no-op context.  The whole-prompt
        modes prefill at admission and keep the separate fused decode."""
        tel = self.tel
        tel.begin_step(self._steps)
        with tel.span("admission"):
            plan = self.policy.plan(self._view())
            progressed = self._execute_preemptions(plan)
            progressed |= self._execute_admissions(plan)
        if self._prefill_mode == "chunked":
            chunk_plan: List[ChunkRow] = []
            if plan.chunks:
                with tel.span("plan_chunks"):
                    chunk_plan = self._materialize_chunks(plan)
            do_decode = bool(plan.decode and self.active)
            if chunk_plan or do_decode:
                rec = self._dispatch(chunk_plan, do_decode)
                self._tick_stats()
                with tel.span("harvest"):
                    self._harvest(rec)
                progressed = True
            else:
                self._tick_stats()
        else:
            self._tick_stats()
            if plan.decode and self.active:
                rec = self._dispatch_decode()
                with tel.span("harvest"):
                    self._harvest(rec)
                progressed = True
        self._t_last = time.perf_counter()
        self._end_step()
        return progressed

    def _step_async(self) -> bool:
        """The one step deep step (depth 1): planning, preemption and
        admission overlap the step the previous call dispatched; then
        its harvest (the one wait for the device), chunk
        materialization against the advanced cursors, and this step's
        dispatch, left in flight.  A plan that preempts drains the
        in-flight step first: the victim's token from it is real
        output, and its pages must not be reclaimed under a dispatch
        that still writes them (slots that finish in that drain are
        skipped by the eviction)."""
        tel = self.tel
        tel.begin_step(self._steps)
        progressed = self.queue.pending > 0
        with tel.span("admission"):
            plan = self.policy.plan(self._view())
            if plan.preempt and self.queue.pending:
                with tel.span("harvest"):
                    self.queue.drain(self._harvest)
            progressed |= self._execute_preemptions(plan)
            progressed |= self._execute_admissions(plan)
        with tel.span("harvest"):
            self.queue.drain(self._harvest)
        if self._prefill_mode == "chunked":
            chunk_plan: List[ChunkRow] = []
            if plan.chunks:
                with tel.span("plan_chunks"):
                    chunk_plan = self._materialize_chunks(plan)
            self._tick_stats()
            do_decode = bool(plan.decode and self.active)
            if chunk_plan or do_decode:
                self.queue.push(self._dispatch(chunk_plan, do_decode))
                progressed = True
        else:
            self._tick_stats()
            if plan.decode and self.active:
                self.queue.push(self._dispatch_decode())
                progressed = True
        self._t_last = time.perf_counter()
        self._end_step()
        return progressed

    def run_until_drained(self, max_steps: int = 1_000_000
                          ) -> List[Completion]:
        steps = 0
        while self._busy():
            if steps >= max_steps:
                raise RuntimeError(f"not drained after {max_steps} steps")
            self.step()
            steps += 1
        return list(self.completed)

    # -- plan construction + execution ----------------------------------
    def _view(self) -> EngineView:
        """The policy's snapshot of host state.  `need_pages` is the
        request's own worst case, minus the prefix the cache already
        holds when it is on (the suffix-only charge); a parked resume
        re-prefills prompt + tokens[:-1]."""
        arena = self.arena
        cfg = self.sched.cfg
        pending = []
        for r in self.sched.pending:
            resume = self._resume.get(r.req_id)
            n_gen = len(resume.tokens) if resume is not None else 0
            total = r.prompt_len + r.max_new_tokens
            need = (arena.admit_cost(total,
                                     tokens=self._resume_source(r, resume))
                    if self._prefix_on else arena.pages_needed(total))
            pending.append(PendingSnap(
                req=r, req_id=r.req_id, priority=r.priority,
                arrival_time=r.arrival_time, prompt_len=r.prompt_len,
                max_new_tokens=r.max_new_tokens,
                source_len=r.prompt_len + max(n_gen - 1, 0),
                need_pages=need, n_generated=n_gen))
        return EngineView(
            now=time.perf_counter(),
            pending=tuple(pending),
            prefilling=tuple(
                PrefillSnap(
                    req_id=st.request.req_id, slot=slot,
                    priority=st.request.priority,
                    arrival_time=st.request.arrival_time,
                    admit_time=st.admit_time, offset=st.offset,
                    total=st.source_len, is_resume=st.resume is not None,
                    pages_committed=arena.committed_for(slot))
                for slot, st in self.prefilling.items()),
            active=tuple(
                DecodeSnap(
                    req_id=st.request.req_id, slot=slot,
                    priority=st.request.priority,
                    arrival_time=st.request.arrival_time,
                    admit_time=st.admit_time,
                    first_token_time=st.first_token_time,
                    n_generated=len(st.tokens),
                    budget_left=st.request.max_new_tokens - len(st.tokens),
                    pages_committed=arena.committed_for(slot))
                for slot, st in self.active.items()),
            free_slots=arena.n_free,
            budget_left=arena.budget_left,
            gauges=arena.gauges(),
            prefill_mode=self._prefill_mode,
            prefill_chunk=cfg.prefill_chunk,
            max_chunks_per_step=cfg.max_chunks_per_step,
            max_prefills_per_step=cfg.max_prefills_per_step,
        )

    def _execute_preemptions(self, plan: StepPlan) -> bool:
        """Evict the planned slots, in reverse so that requeueing at the
        head leaves them in plan order.  A slot no longer leased is
        skipped: plans are advisory."""
        did = False
        for slot in reversed(plan.preempt):
            did |= self._preempt_slot(slot)
        return did

    def _preempt_slot(self, slot: int) -> bool:
        """Release the slot's pages and lease, park a decode's progress
        in a ResumeState and requeue the request at the queue head; the
        re-prefill rebuilds the KV image bit for bit."""
        if slot in self.prefilling:
            st = self.prefilling.pop(slot)
            req, resume = st.request, st.resume
            if resume is not None:
                resume.n_preempts += 1
        elif slot in self.active:
            ast = self.active.pop(slot)
            req = ast.request
            resume = ResumeState(
                tokens=list(ast.tokens),
                first_token_time=ast.first_token_time,
                admit_time=ast.admit_time,
                emit_times=list(ast.emit_times),
                n_preempts=ast.n_preempts + 1)
        else:
            return False  # already finished and released
        self._n_preempts += 1
        if self.tel.enabled:
            self.tel.event(
                "preempt", req_id=req.req_id, slot=slot, reason="policy",
                n_generated=len(resume.tokens) if resume is not None else 0)
        self.arena.release(slot)
        if resume is not None:
            self._resume[req.req_id] = resume
        self.sched.requeue(req)
        return True

    def _execute_admissions(self, plan: StepPlan) -> bool:
        """Lease slots to the planned requests in plan order; the arena
        predicate is re-checked per admission."""
        progressed = False
        for req in plan.admit:
            if not self.sched.take(req):
                continue
            total = req.prompt_len + req.max_new_tokens
            tokens = (self._resume_source(req, self._resume.get(req.req_id))
                      if self._prefix_on else None)
            if not self.arena.can_admit(req.prompt_len, total,
                                        tokens=tokens):
                self.sched.requeue(req)
                plan.rejects.append(
                    (req.req_id,
                     self.arena.reject_reason(req.prompt_len, total)))
                break
            self._admit(req)
            progressed = True
        self._n_admit_rejects += len(plan.rejects)
        if self.tel.enabled:
            for req_id, reason in plan.rejects:
                self.tel.event("admit_reject", req_id=req_id, reason=reason)
        return progressed

    def _resume_source(self, req: Request,
                       resume: Optional[ResumeState]) -> np.ndarray:
        """What to prefill: the prompt, or prompt + tokens[:-1] for a
        preempted request, whose last row regenerates tokens[-1]."""
        if resume is None:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(resume.tokens[:-1], np.int32)])

    def _admit(self, req: Request):
        """Lease a slot and start the request's prefill: the chunked mode
        only enqueues it (the chunk cursor starts where the arena's
        installed shared prefix ends), the whole-prompt modes prefill
        now (`_admit_whole`).  A resumed request keeps its original
        stamps."""
        resume = self._resume.pop(req.req_id, None)
        if self._prefill_mode != "chunked":
            self._admit_whole(req, resume)
            return
        source = self._resume_source(req, resume)
        slot = self.arena.alloc(
            req.req_id, int(source.size), req.prompt_len + req.max_new_tokens,
            written=0, tokens=source if self._prefix_on else None)
        off0 = int(self.arena.lengths[slot]) if self._prefix_on else 0
        self.prefilling[slot] = PrefillState(
            request=req, slot=slot, offset=off0,
            admit_time=(resume.admit_time if resume is not None
                        else time.perf_counter()),
            source=source, resume=resume)
        if self.tel.enabled:
            self.tel.event("admit", req_id=req.req_id, slot=slot)
            if self._prefix_on:
                pages = int(self.arena.shared_at_admit[slot])
                if pages:
                    self.tel.event("prefix_hit", req_id=req.req_id,
                                   slot=slot, pages=pages, tokens=off0)
                else:
                    self.tel.event("prefix_miss", req_id=req.req_id,
                                   slot=slot)

    def _admit_whole(self, req: Request, resume: Optional[ResumeState]):
        """Prefill the source at batch 1 (bucket-padded or exact length)
        and lease a slot: the one-shot path.  On resume the source is
        prompt + tokens[:-1] and the prefill's last-position argmax must
        equal tokens[-1]."""
        source = self._resume_source(req, resume)
        L = int(source.size)
        slot = self.arena.alloc(req.req_id, L,
                                req.prompt_len + req.max_new_tokens)
        admit_t = (resume.admit_time if resume is not None
                   else time.perf_counter())
        if self.tel.enabled:
            self.tel.event("admit", req_id=req.req_id, slot=slot)
        Pb = (self.sched.bucket_len(L) if self._prefill_mode == "bucketed"
              else L)
        padded = np.zeros((1, Pb), np.int32)
        padded[0, :L] = source
        self.tel.dispatch("prefill", (Pb,))
        # first token: greedy at the TRUE last source position (the
        # padded positions after it are causally invisible to it)
        with self.tel.annotate("repro_torch.serving/prefill"):
            first = self._prefill_one(padded, L - 1)
        self.arena.write_slot(slot, self._scratch)
        now = time.perf_counter()
        if resume is not None:
            self._resume_decoding(req, slot, first, resume)
        else:
            self._start_decoding(req, slot, first, now, admit_t)

    def _dispatch_ctx(self):
        """Every dispatch's context: the attention's path
        (``paged_decode``) and, over a kv-sharded arena, the mesh's
        profile (the per-rank head range)."""
        stack = contextlib.ExitStack()
        stack.enter_context(
            variants.use_variants(paged_decode=self._paged_decode))
        if self.mesh is not None and self.kv_shard:
            stack.enter_context(use_profile(self.mesh))
        return stack

    def _prefill_one(self, padded: np.ndarray, last: int) -> int:
        """The B=1 prefill into the zeroed scratch cache; -> the first
        token (the one host sync of an admission)."""
        if self._scratch is None:
            self._scratch = self.lm.init_caches(
                1, self.arena.max_len, device=self.device,
                kv_heads=self.arena.kv_heads)
        for key in ("conv", "h", "k", "v"):
            if key in self._scratch:
                self._scratch[key].zero_()
        with self._dispatch_ctx():
            logits = self.lm.prefill(self.tables,
                                     self.arena.to_device(padded),
                                     self._scratch, last_index=last)
        return int(torch.argmax(logits[0, 0]))

    def _materialize_chunks(self, plan: StepPlan) -> List[ChunkRow]:
        """Resolve the plan's (req_id, n) rows against live prefill
        state; n is clamped to the chunk width and remaining prompt."""
        by_id = {st.request.req_id: st for st in self.prefilling.values()}
        C = self.sched.cfg.prefill_chunk
        out: List[ChunkRow] = []
        seen = set()
        for req_id, n in plan.chunks:
            st = by_id.get(req_id)
            if st is None or req_id in seen:
                continue
            seen.add(req_id)
            n = min(int(n), C, st.source_len - st.offset)
            if n > 0:
                out.append((st, st.offset, n))
        return out

    def _tick_stats(self):
        self._occupancy_sum += self.arena.n_leased / self.arena.n_slots
        self._max_active = max(self._max_active, len(self.active))
        self._steps += 1

    def _end_step(self):
        """Close the telemetry step record, folding in the queue depth
        and the gauges (host counters only)."""
        if not self.tel.enabled:
            return
        self.tel.end_step(
            queue_depth=self.queue.pending,
            n_pending=self.sched.n_pending,
            n_active=len(self.active),
            n_prefilling=len(self.prefilling),
            admit_rejects=self._n_admit_rejects,
            **self.arena.gauges(),
        )

    @staticmethod
    def _to_host(nxt: torch.Tensor):
        """-> (host tensor, CUDA event or None): on the card the token
        vector's copy into pinned host memory, enqueued behind the step;
        the harvest waits on its event."""
        if not nxt.is_cuda:
            return nxt, None
        host = torch.empty(nxt.shape, dtype=nxt.dtype, pin_memory=True)
        host.copy_(nxt, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _decode(self, toks: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """Enqueue one decode_step over every slot row and the greedy
        argmax; -> the (n_slots,) next-token vector on the device."""
        with self._dispatch_ctx():
            logits = self.lm.decode_step(
                self.tables, self.arena.to_device(toks),
                self.arena.decode_view(), self.arena.to_device(pos))
        return torch.argmax(logits[:, 0, :], dim=-1)

    def _dispatch_decode(self) -> _InFlightStep:
        """The whole-prompt modes' fused decode over every slot row;
        rows without an active decode park at INACTIVE_POS, token 0."""
        tel = self.tel
        with tel.span("decode_dispatch"):
            B = self.arena.n_slots
            toks = np.zeros((B, 1), np.int32)
            pos = np.full((B,), INACTIVE_POS, np.int32)
            for slot, st in self.active.items():
                toks[slot, 0] = st.last_token
                pos[slot] = st.pos
                self.arena.touch(slot, st.pos)
            tel.dispatch("decode", (B,))
            with tel.annotate("repro_torch.serving/decode"):
                nxt = self._decode(toks, pos)
            host, done = self._to_host(nxt)
        return _InFlightStep(tokens=nxt, host=host, done=done, chunk_plan=[],
                             decode_slots=list(self.active))

    def _unified(self, toks: np.ndarray, start: np.ndarray,
                 last: np.ndarray) -> torch.Tensor:
        """Enqueue one prefill_chunk over every row and the greedy
        argmax; -> the (n_slots,) next-token vector on the device."""
        with self._dispatch_ctx():
            logits = self.lm.prefill_chunk(
                self.tables, self.arena.to_device(toks),
                self.arena.decode_view(), self.arena.to_device(start),
                self.arena.to_device(last))
        return torch.argmax(logits[:, 0, :], dim=-1)

    def _dispatch(self, chunk_plan: List[ChunkRow],
                  do_decode: bool) -> _InFlightStep:
        """THE unified dispatch over every arena row (row = slot)."""
        tel = self.tel
        with tel.span("unified_dispatch"):
            B = self.arena.n_slots
            C = self.sched.cfg.prefill_chunk
            W = C if chunk_plan else 1
            toks = np.zeros((B, W), np.int32)
            start = np.full((B,), INACTIVE_POS, np.int32)
            last = np.zeros((B,), np.int32)
            decode_slots: List[int] = []
            if do_decode:
                for slot, st in self.active.items():
                    toks[slot, 0] = st.last_token
                    start[slot] = st.pos
                    self.arena.touch(slot, st.pos)
                    decode_slots.append(slot)
            for st, off, n in chunk_plan:
                toks[st.slot, :n] = st.source[off:off + n]
                start[st.slot] = off
                last[st.slot] = n - 1
                self.arena.touch_range(st.slot, off, off + n)
                if tel.enabled:
                    tel.event(
                        "prefill_chunk", req_id=st.request.req_id,
                        slot=st.slot, start=off, end=off + n,
                        pages=self.arena.span_pages(st.slot, off, off + n))
            tel.dispatch("unified", (B, W))
            with tel.annotate("repro_torch.serving/unified"):
                nxt = self._unified(toks, start, last)
            host, done = self._to_host(nxt)
        return _InFlightStep(tokens=nxt, host=host, done=done,
                             chunk_plan=chunk_plan,
                             decode_slots=decode_slots)

    def _harvest(self, rec: _InFlightStep):
        """Wait for the step's token vector (the pipeline's one
        blocking point) and advance host state.  Decode slots in
        `rec.decode_slots` cannot have been released in between: the
        only release site is a harvest."""
        if rec.done is not None:
            rec.done.synchronize()
        nxt = rec.host.numpy()
        now = time.perf_counter()
        for slot in rec.decode_slots:
            st = self.active[slot]
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.last_token = tok
            st.pos += 1
            st.emit_times.append(now)
            self.arena.advance(slot)
            if self._prefix_on and st.pos % self.arena.page_size == 0:
                # a page just filled: publish it (this keeps a later
                # preemption victim's pages warm through its release)
                self.arena.register_prefix(
                    slot, np.concatenate(
                        [st.request.prompt, np.asarray(st.tokens, np.int32)]),
                    st.pos)
            self._emit(st.request, tok, slot)
            self._maybe_finish(st, now)
        for st, off, n in rec.chunk_plan:
            self.arena.advance(st.slot, n)
            if self._prefix_on:
                # every position below off + n is final: publish the
                # full pages
                self.arena.register_prefix(st.slot, st.source, off + n)
            if off + n < st.source_len:
                st.offset = off + n
                continue
            del self.prefilling[st.slot]  # final chunk completed
            if st.resume is not None:
                self._resume_decoding(st.request, st.slot, int(nxt[st.slot]),
                                      st.resume)
            else:
                self._start_decoding(st.request, st.slot, int(nxt[st.slot]),
                                     now, st.admit_time)

    def _start_decoding(self, req: Request, slot: int, first: int,
                        now: float, admit_time: float):
        """Graduate a prefilled request to decode; TTFT stops here."""
        st = RequestState(
            request=req, slot=slot, tokens=[first], last_token=first,
            pos=req.prompt_len, first_token_time=now,
            admit_time=admit_time, emit_times=[now])
        self.active[slot] = st
        if self.tel.enabled:
            self.tel.event("first_token", req_id=req.req_id, slot=slot,
                           token=first)
        self._emit(req, first, slot)
        self._maybe_finish(st, now)

    def _resume_decoding(self, req: Request, slot: int, predicted: int,
                         resume: ResumeState):
        """Re-enter decode after a preemption's re-prefill, emitting
        nothing.  The source was prompt + tokens[:-1], so its last row
        must regenerate tokens[-1]: the resume-parity oracle."""
        if predicted != resume.tokens[-1]:
            raise RuntimeError(
                "resume parity violated: re-prefill regenerated token "
                f"{predicted} but the preempted request had emitted "
                f"{resume.tokens[-1]} (req {req.req_id})")
        self.active[slot] = RequestState(
            request=req, slot=slot, tokens=list(resume.tokens),
            last_token=resume.tokens[-1],
            pos=req.prompt_len + len(resume.tokens) - 1,
            first_token_time=resume.first_token_time,
            admit_time=resume.admit_time,
            emit_times=list(resume.emit_times),
            n_preempts=resume.n_preempts)
        if self.tel.enabled:
            self.tel.event("resume", req_id=req.req_id, slot=slot,
                           n_preempts=resume.n_preempts)

    def _on_cow(self, slot: int, old_page: int, new_page: int):
        """Arena hook: a copy-on-write split while touching `slot` (in
        the dispatch's touch loop, so the slot is prefilling or
        active)."""
        if not self.tel.enabled:
            return
        st = self.prefilling.get(slot) or self.active.get(slot)
        self.tel.event("cow_split",
                       req_id=st.request.req_id if st is not None else -1,
                       slot=slot, old_page=old_page, new_page=new_page)

    def _emit(self, req: Request, tok: int, slot: int):
        self._n_generated += 1
        if self.tel.enabled:
            self.tel.event("emit", req_id=req.req_id, slot=slot, token=tok)
        if self.on_token is not None:
            self.on_token(req.req_id, tok)

    def _maybe_finish(self, st: RequestState, now: float):
        req = st.request
        if req.stop_token is not None and st.last_token == req.stop_token:
            reason = FINISH_STOP
        elif len(st.tokens) >= req.max_new_tokens:
            reason = FINISH_LENGTH
        elif st.pos >= self.arena.max_len:
            reason = FINISH_MAX_LEN  # unreachable when submit() validates
        else:
            return
        self.completed.append(Completion(
            req_id=req.req_id, prompt_len=req.prompt_len,
            tokens=list(st.tokens), finish_reason=reason,
            arrival_time=req.arrival_time,
            first_token_time=st.first_token_time, finish_time=now,
            admit_time=st.admit_time, emit_times=list(st.emit_times),
            n_preempts=st.n_preempts))
        if self.tel.enabled:
            self.tel.event("finish", req_id=req.req_id, slot=st.slot,
                           reason=reason, n_generated=len(st.tokens))
        del self.active[st.slot]
        self.arena.release(st.slot)

    # -- warmup -------------------------------------------------------
    def _busy(self) -> bool:
        return bool(self.sched.n_pending or self.prefilling or self.active
                    or self.queue.pending)

    def warmup(self):
        """Run every step dispatch shape once with every row parked at
        INACTIVE_POS, so the first step of a measured window meets no
        first-use cost (the kernels' build, the GEMM workspace, torch's
        caches): in the chunked mode both unified widths, (n_slots, 1)
        and (n_slots, C), else the fused decode.  Parked rows write only
        the trash page, so every page a request can hold is left
        byte-equal; the results are dropped.  The shapes are registered
        with the telemetry's dispatch counters, so a warmed window reads
        all hits.  The whole-prompt prefill is not warmed: its shapes
        follow the workload's prompt lengths.  Requires an idle
        engine."""
        if self._busy():
            raise RuntimeError("warmup on a non-idle engine")
        B = self.arena.n_slots
        parked = np.full((B,), INACTIVE_POS, np.int32)
        if self._prefill_mode != "chunked":
            self.tel.dispatch("decode", (B,))
            self._decode(np.zeros((B, 1), np.int32), parked).cpu()
            return
        for W in (1, self.sched.cfg.prefill_chunk):
            self.tel.dispatch("unified", (B, W))
            self._unified(np.zeros((B, W), np.int32), parked,
                          np.zeros((B,), np.int32)).cpu()

    # -- statistics -----------------------------------------------------
    def reset_stats(self):
        """Zero the run statistics and the completion log (e.g. after a
        warmup workload), restart the arena's peaks and clear the
        telemetry buffers.  Requires an idle engine: in-flight state
        would skew the next window."""
        if self._busy():
            raise RuntimeError("reset_stats on a non-idle engine")
        self.completed.clear()
        self._steps = 0
        self._occupancy_sum = 0.0
        self._n_generated = 0
        self._max_active = 0
        self._n_admit_rejects = 0
        self._n_preempts = 0
        self._t_first = None
        self._t_last = None
        self.arena.reset_peaks()
        self.tel.clear()

    def stats(self) -> dict:
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        ttfts = [c.ttft for c in self.completed]
        itls = [d for c in self.completed for d in c.itl]
        queued = [c.queued_s for c in self.completed]
        prefills = [c.prefill_s for c in self.completed]
        decodes = [c.decode_s for c in self.completed]

        def mean(xs):
            return float(np.mean(xs)) if xs else 0.0

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        out = {
            "n_completed": len(self.completed),
            "n_generated": self._n_generated,
            "steps": self._steps,
            "wall_s": wall,
            "throughput_tok_s": (self._n_generated / wall) if wall else 0.0,
            "mean_ttft_s": mean(ttfts),
            "p50_ttft_s": pct(ttfts, 50),
            "p95_ttft_s": pct(ttfts, 95),
            "p99_ttft_s": pct(ttfts, 99),
            "max_ttft_s": float(np.max(ttfts)) if ttfts else 0.0,
            # inter-token latency: pooled per-request emit gaps
            "mean_itl_s": mean(itls),
            "p50_itl_s": pct(itls, 50),
            "p95_itl_s": pct(itls, 95),
            "p99_itl_s": pct(itls, 99),
            # where a request's wall time went
            "mean_queued_s": mean(queued),
            "mean_prefill_s": mean(prefills),
            "mean_decode_s": mean(decodes),
            "admit_rejects": self._n_admit_rejects,
            "n_preempts": self._n_preempts,  # policy evictions executed
            "policy": getattr(self.policy, "name", "?"),
            "mean_occupancy": (
                self._occupancy_sum / self._steps if self._steps else 0.0),
            "max_active": self._max_active,
            "dispatch_depth": self.queue.depth,
            "mesh_devices": (1 if self.mesh is None
                             else int(self.mesh.mesh.numel())),
            "kv_shard": self.kv_shard,
            "device": str(self.device),
        }
        out.update(self.arena.stats())
        return out
