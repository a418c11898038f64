"""`ServingEngine`: continuous batching over the integer-only model
(port of `repro.serving.engine.ServingEngine`, the default path:
FCFS policy, synchronous steps, paged arena, chunked prefill, int8 or
int4-packed KV (`ServingConfig.kv_bits`), telemetry).

Each `step()`:

  1. samples a read-only `EngineView` and asks the policy for a
     `StepPlan`;
  2. admits the planned requests (lease a slot, commit the page
     budget);
  3. issues ONE unified dispatch of `DecoderLM.prefill_chunk` over
     every arena row: decode rows carry their last token as a width-1
     chunk at their decode position, prefill rows carry the next chunk
     of their prompt at their offset, everything else parks at
     INACTIVE_POS.  The dispatch width is the chunk width C when any
     prefill row rides along and 1 otherwise, so exactly two shapes
     exist, (n_slots, C) and (n_slots, 1), both run by `warmup()`;
  4. takes each row's next token by greedy argmax on the device over
     the int32 logits (first index on ties, like `jnp.argmax`) and
     harvests the (n_slots,) token vector, the step's one host sync.

Telemetry (`ServingConfig.telemetry`, DESIGN.md §Observability): the
engine threads an off-by-default, bit-neutral sink through every
lifecycle transition (the reference's trace events), every step phase
(spans `admission`, `plan_chunks`, `unified_dispatch`, `harvest`) and
every dispatch (shape counters, and `torch.profiler.record_function`
ranges when `profile_annotations` is on).  The hooks read host state
only, so telemetry cannot change a token.  On the card the kernels run
asynchronously to the host, so `unified_dispatch` times the host's
work to build and enqueue a step (Python, torch dispatch and kernel
launches) and `harvest` times the wait for the device to finish it
(the `nxt.cpu()` sync) plus the host bookkeeping after it.  Per-token
emit stamps always accrue on the completions, and `stats()` rolls
them up into TTFT / ITL percentiles and the queued / prefill / decode
breakdown.

Left out of the port so far (later slices port them): the prefix trie
and copy-on-write, warm pages, preemption and `PrioritySLOPolicy`, the
async depth-1 dispatch queue, mesh and kv-head sharding, `SlotArena`
and the whole-prompt prefill modes.  Their `stats()` keys read as the
reference's do without them: `n_preempts` 0, `dispatch_depth` 0,
`mesh_devices` 1, `kv_shard` False.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.layers.attention import INACTIVE_POS
from repro_torch.serving.cache import PagedArena
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.policy import (
    DecodeSnap, EngineView, FCFSPolicy, PendingSnap, PrefillSnap, StepPlan,
)
from repro_torch.serving.request import (
    FINISH_LENGTH, FINISH_MAX_LEN, FINISH_STOP, Completion, PrefillState,
    Request, RequestState,
)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.telemetry import NULL

ChunkRow = Tuple[PrefillState, int, int]  # (state, offset, n_tokens)


class ServingEngine:
    def __init__(self, lm, tables, config: Optional[ServingConfig] = None,
                 *, on_token: Optional[Callable[[int, int], None]] = None):
        cfg = self.config = config if config is not None else ServingConfig()
        self.lm = lm
        self.tables = tables
        self.device = torch.device(cfg.device)
        self.policy = cfg.policy if cfg.policy is not None else FCFSPolicy()
        self.arena = PagedArena(
            lm, cfg.n_slots, cfg.max_len, cfg.page_size, cfg.n_pages,
            device=self.device, kv_bits=cfg.kv_bits)
        self.sched = Scheduler(cfg.scheduler, cfg.max_len)
        self.on_token = on_token
        self.tel = cfg.telemetry if cfg.telemetry is not None else NULL
        self.active: Dict[int, RequestState] = {}  # slot -> decode state
        # slot -> chunked-prefill progress, in admission order
        self.prefilling: Dict[int, PrefillState] = {}
        self.completed: List[Completion] = []
        self._next_id = 0
        self._steps = 0
        self._n_generated = 0
        self._n_admit_rejects = 0
        self._occupancy_sum = 0.0
        self._max_active = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- submission -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               stop_token: Optional[int] = None) -> int:
        """Enqueue a request; returns its req_id."""
        req = (prompt if isinstance(prompt, Request)
               else Request(prompt, max_new_tokens, stop_token))
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
        Telemetry spans time each phase (the reference's `_step_sync`);
        with the Null sink each span is a shared no-op context."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        tel = self.tel
        tel.begin_step(self._steps)
        with tel.span("admission"):
            plan = self.policy.plan(self._view())
            progressed = self._execute_admissions(plan)
        chunk_plan: List[ChunkRow] = []
        if plan.chunks:
            with tel.span("plan_chunks"):
                chunk_plan = self._materialize_chunks(plan)
        do_decode = bool(plan.decode and self.active)
        if chunk_plan or do_decode:
            rec = self._dispatch(chunk_plan, do_decode)
            self._tick_stats()
            with tel.span("harvest"):
                self._harvest(*rec)
            progressed = True
        else:
            self._tick_stats()
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
        arena = self.arena
        cfg = self.sched.cfg
        return EngineView(
            now=time.perf_counter(),
            pending=tuple(
                PendingSnap(
                    req=r, req_id=r.req_id, arrival_time=r.arrival_time,
                    prompt_len=r.prompt_len,
                    max_new_tokens=r.max_new_tokens,
                    need_pages=arena.pages_needed(
                        r.prompt_len + r.max_new_tokens))
                for r in self.sched.pending),
            prefilling=tuple(
                PrefillSnap(
                    req_id=st.request.req_id, slot=slot,
                    admit_time=st.admit_time, offset=st.offset,
                    total=st.source_len)
                for slot, st in self.prefilling.items()),
            active=tuple(
                DecodeSnap(
                    req_id=st.request.req_id, slot=slot,
                    first_token_time=st.first_token_time,
                    n_generated=len(st.tokens),
                    budget_left=st.request.max_new_tokens - len(st.tokens))
                for slot, st in self.active.items()),
            free_slots=arena.n_free,
            budget_left=arena.budget_left,
            prefill_chunk=cfg.prefill_chunk,
            max_chunks_per_step=cfg.max_chunks_per_step,
            max_prefills_per_step=cfg.max_prefills_per_step,
        )

    def _execute_admissions(self, plan: StepPlan) -> bool:
        """Lease slots to the planned requests in plan order; the arena
        predicate is re-checked per admission."""
        progressed = False
        for req in plan.admit:
            if not self.sched.take(req):
                continue
            total = req.prompt_len + req.max_new_tokens
            if not self.arena.can_admit(req.prompt_len, total):
                self.sched.requeue(req)
                plan.rejects.append(
                    (req.req_id,
                     self.arena.reject_reason(req.prompt_len, total)))
                break
            slot = self.arena.alloc(req.req_id, req.prompt_len, total,
                                    written=0)
            self.prefilling[slot] = PrefillState(
                request=req, slot=slot, admit_time=time.perf_counter())
            if self.tel.enabled:
                self.tel.event("admit", req_id=req.req_id, slot=slot)
            progressed = True
        self._n_admit_rejects += len(plan.rejects)
        if self.tel.enabled:
            for req_id, reason in plan.rejects:
                self.tel.event("admit_reject", req_id=req_id, reason=reason)
        return progressed

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
        """Close the telemetry step record, folding in the gauges (host
        counters only; no dispatch queue yet, so its depth is 0)."""
        if not self.tel.enabled:
            return
        self.tel.end_step(
            queue_depth=0,
            n_pending=self.sched.n_pending,
            n_active=len(self.active),
            n_prefilling=len(self.prefilling),
            admit_rejects=self._n_admit_rejects,
            **self.arena.gauges(),
        )

    def _unified(self, toks: np.ndarray, start: np.ndarray,
                 last: np.ndarray) -> torch.Tensor:
        """Enqueue one prefill_chunk over every row and the greedy
        argmax; -> the (n_slots,) next-token vector on the device."""
        dev = self.device
        logits = self.lm.prefill_chunk(
            self.tables,
            torch.from_numpy(toks).to(dev),
            self.arena.decode_view(),
            torch.from_numpy(start).to(dev),
            torch.from_numpy(last).to(dev),
        )
        return torch.argmax(logits[:, 0, :], dim=-1)

    def _dispatch(self, chunk_plan: List[ChunkRow], do_decode: bool):
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
        return nxt, chunk_plan, decode_slots

    def _harvest(self, nxt: torch.Tensor, chunk_plan: List[ChunkRow],
                 decode_slots: List[int]):
        """Block on the step's token vector and advance host state."""
        nxt = nxt.cpu().numpy()
        now = time.perf_counter()
        for slot in decode_slots:
            st = self.active[slot]
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.last_token = tok
            st.pos += 1
            st.emit_times.append(now)
            self.arena.advance(slot)
            self._emit(st.request, tok, slot)
            self._maybe_finish(st, now)
        for st, off, n in chunk_plan:
            self.arena.advance(st.slot, n)
            if off + n < st.source_len:
                st.offset = off + n
                continue
            del self.prefilling[st.slot]  # final chunk completed
            self._start_decoding(st, int(nxt[st.slot]), now)

    def _start_decoding(self, pst: PrefillState, first: int, now: float):
        """Graduate a prefilled request to decode; TTFT stops here."""
        req = pst.request
        st = RequestState(
            request=req, slot=pst.slot, tokens=[first], last_token=first,
            pos=req.prompt_len, first_token_time=now,
            admit_time=pst.admit_time, emit_times=[now])
        self.active[pst.slot] = st
        if self.tel.enabled:
            self.tel.event("first_token", req_id=req.req_id, slot=pst.slot,
                           token=first)
        self._emit(req, first, pst.slot)
        self._maybe_finish(st, now)

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
            admit_time=st.admit_time, emit_times=list(st.emit_times)))
        if self.tel.enabled:
            self.tel.event("finish", req_id=req.req_id, slot=st.slot,
                           reason=reason, n_generated=len(st.tokens))
        del self.active[st.slot]
        self.arena.release(st.slot)

    # -- warmup -------------------------------------------------------
    def _busy(self) -> bool:
        return bool(self.sched.n_pending or self.prefilling or self.active)

    def warmup(self):
        """Run both dispatch shapes once, (n_slots, 1) and (n_slots, C),
        with every row parked at INACTIVE_POS, so the first step of a
        measured window meets no first-use cost (the kernels' build,
        the GEMM workspace, torch's caches).  Parked rows write only
        the PAGE_NULL trash page, so every page a request can hold is
        left byte-equal; the results are dropped.  Both shapes are
        registered with the telemetry's dispatch counters, so a warmed
        window reads all hits.  Requires an idle engine."""
        if self._busy():
            raise RuntimeError("warmup on a non-idle engine")
        B = self.arena.n_slots
        parked = np.full((B,), INACTIVE_POS, np.int32)
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
            "n_preempts": 0,  # FCFS never preempts
            "policy": getattr(self.policy, "name", "?"),
            "mean_occupancy": (
                self._occupancy_sum / self._steps if self._steps else 0.0),
            "max_active": self._max_active,
            "dispatch_depth": 0,
            "mesh_devices": 1,
            "kv_shard": False,
            "device": str(self.device),
        }
        out.update(self.arena.stats())
        return out
