"""Request / response contract for the continuous-batching engine
(port of `repro.serving.request`, framework-free).

A `Request` is the unit of admission: one prompt, a generation budget,
and an optional stop token.  The engine stamps `req_id` and
`arrival_time` at submit().  A `Completion` is the terminal record;
all timing fields are host wall-clock (time.perf_counter) stamps, so
TTFT and latency compare directly across requests of one run.

`ResumeState` is what a preemption parks host-side: the generated
tokens and the original stamps.  The request re-prefills
`prompt + tokens[:-1]` and resumes decoding from `tokens[-1]`; integer
determinism makes the rebuilt KV image bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

FINISH_STOP = "stop"  # generated the request's stop token
FINISH_LENGTH = "length"  # hit max_new_tokens
FINISH_MAX_LEN = "max_len"  # hit the arena's sequence capacity (defensive)


@dataclasses.dataclass
class Request:
    """One generation request (prompt tokens + budget).  `priority` is
    a scheduling-class hint for SLO-aware policies (larger is more
    urgent); FCFS ignores it."""

    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    stop_token: Optional[int] = None
    priority: int = 0  # policy hint; FCFS ignores it
    req_id: int = -1  # stamped by ServingEngine.submit()
    arrival_time: float = 0.0  # stamped by ServingEngine.submit()

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


@dataclasses.dataclass
class ResumeState:
    """Decode progress carried across a preemption: the tokens
    generated so far (tokens[-1] is the next decode input) and the
    original stamps, so queued_s and the ITL series span the stall."""

    tokens: List[int]
    first_token_time: float
    admit_time: float  # original slot-lease stamp
    emit_times: List[float] = dataclasses.field(default_factory=list)
    n_preempts: int = 1  # times this request has been evicted


@dataclasses.dataclass
class PrefillState:
    """Engine-internal chunked-prefill progress for a leased slot:
    `offset` source tokens are already in the arena, the next chunk
    covers [offset, offset + chunk).  `source` is the prompt, or on a
    resume (`resume` set) `prompt + resume.tokens[:-1]`, whose last
    row's logits must regenerate `resume.tokens[-1]`."""

    request: Request
    slot: int
    offset: int = 0
    admit_time: float = 0.0  # slot-lease stamp
    source: Optional[np.ndarray] = None  # None -> request.prompt
    resume: Optional[ResumeState] = None

    def __post_init__(self):
        if self.source is None:
            self.source = self.request.prompt

    @property
    def source_len(self) -> int:
        return int(self.source.size)


@dataclasses.dataclass
class RequestState:
    """Engine-internal per-slot decode state.  `pos` is the next cache
    write position: prompt_len + len(tokens) - 1."""

    request: Request
    slot: int
    tokens: List[int]
    last_token: int
    pos: int
    first_token_time: float
    admit_time: float = 0.0
    emit_times: List[float] = dataclasses.field(default_factory=list)
    n_preempts: int = 0  # evictions survived (a resume carries it over)


@dataclasses.dataclass
class Completion:
    """Terminal record for a drained request."""

    req_id: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str
    arrival_time: float
    first_token_time: float
    finish_time: float
    admit_time: float = 0.0
    emit_times: List[float] = dataclasses.field(default_factory=list)
    n_preempts: int = 0  # evictions this request survived

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft(self) -> float:
        """Time-to-first-token (queueing + prefill), seconds."""
        return self.first_token_time - self.arrival_time

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def itl(self) -> List[float]:
        """Gaps between consecutive token emissions."""
        return [b - a for a, b in zip(self.emit_times, self.emit_times[1:])]

    # -- latency breakdown (queued / prefill / decode) ------------------
    @property
    def queued_s(self) -> float:
        """Arrival -> slot lease (admission queueing)."""
        return self.admit_time - self.arrival_time

    @property
    def prefill_s(self) -> float:
        """Slot lease -> first generated token (the chunked prefill)."""
        return self.first_token_time - self.admit_time

    @property
    def decode_s(self) -> float:
        """First generated token -> finish (pure decode)."""
        return self.finish_time - self.first_token_time
