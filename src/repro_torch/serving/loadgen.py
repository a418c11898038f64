"""Open-loop load generation and goodput under SLOs (port of
`repro.serving.loadgen`; DESIGN.md §Scheduling ¶Open-loop harness).

Closed-loop replay (submit everything, drain) measures service
capacity but not goodput: with no arrival process there is no offered
rate to sustain.  This module supplies the load side, an arrival
schedule (Poisson, or an explicit trace of offsets), and
`run_open_loop`, which submits requests to a `ServingEngine` at their
wall-clock arrival times, steps the engine between arrivals, and rolls
the completions up into SLO-aware metrics:

  goodput_qps     completed requests per second that met BOTH their
                  SLOs (TTFT <= slo_ttft_s and the request's own p95
                  ITL <= slo_itl_s)
  sustained       whether the AGGREGATE p99 TTFT / ITL met the
                  targets at this offered rate

The integer engine is deterministic, so an open-loop run's tokens are
the closed loop's; only the timing (and so SLO attainment) depends on
the load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Completion, Request


def poisson_arrivals(n: int, rate_qps: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of `n` requests from a
    Poisson process at `rate_qps`: i.i.d. exponential gaps."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def shared_prefix_workload(n: int, vocab: int, rng: np.random.Generator, *,
                           prefix_len: int, suffix_len: int,
                           max_new_tokens: int) -> List[Request]:
    """System-prompt workload: `n` requests sharing ONE random
    `prefix_len`-token prefix, each with its own random
    `suffix_len`-token tail: what the prefix cache shares
    (`ServingConfig.prefix_cache`)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if prefix_len < 0 or suffix_len < 0:
        raise ValueError("prefix_len and suffix_len must be >= 0")
    prefix = rng.integers(0, vocab, size=(prefix_len,))
    return [
        Request(np.concatenate(
            [prefix, rng.integers(0, vocab, size=(suffix_len,))]
        ).astype(np.int32), max_new_tokens=max_new_tokens)
        for _ in range(n)
    ]


def trace_arrivals(offsets: Sequence[float]) -> np.ndarray:
    """Validate an explicit arrival trace: non-negative offsets
    (seconds from run start), sorted ascending."""
    arr = np.asarray(list(offsets), dtype=float)
    if arr.ndim != 1 or arr.size < 1:
        raise ValueError("arrival trace must be a non-empty 1-D list")
    if (arr < 0).any():
        raise ValueError("arrival offsets must be >= 0")
    return np.sort(arr)


@dataclasses.dataclass
class OpenLoopResult:
    """Roll-up of one open-loop run at one offered rate."""

    n_requests: int
    n_completed: int
    wall_s: float
    offered_qps: float  # n_requests / last arrival offset
    completed_qps: float
    goodput_qps: float  # per-request-SLO-meeting completions / wall
    slo_attainment: float  # fraction of requests meeting their SLOs
    p50_ttft_s: float
    p99_ttft_s: float
    p99_itl_s: float  # pooled across requests
    slo_ttft_s: Optional[float]
    slo_itl_s: Optional[float]
    sustained: Optional[bool]  # aggregate p99s met targets (None: no SLO)
    n_preempts: int
    completions: List[Completion]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("completions")
        return d


def _request_meets_slo(c: Completion, slo_ttft_s: Optional[float],
                       slo_itl_s: Optional[float]) -> bool:
    if slo_ttft_s is not None and c.ttft > slo_ttft_s:
        return False
    if slo_itl_s is not None and c.itl:
        # per-request tail: p95 of its own gap series
        if float(np.percentile(c.itl, 95)) > slo_itl_s:
            return False
    return True


def run_open_loop(engine, requests: Sequence[Request],
                  arrivals: Sequence[float], *,
                  slo_ttft_s: Optional[float] = None,
                  slo_itl_s: Optional[float] = None,
                  max_steps: int = 1_000_000) -> OpenLoopResult:
    """Drive `engine` with an open-loop arrival schedule: request i is
    submitted once the wall clock passes `arrivals[i]` (seconds from
    run start), whatever the service progress; queueing under overload
    is the measurement.  Steps the engine while busy and naps briefly
    when idle before the next arrival.  -> the SLO roll-up over this
    run's completions."""
    if len(requests) != len(arrivals):
        raise ValueError(
            f"{len(requests)} requests but {len(arrivals)} arrivals")
    offs = np.asarray(arrivals, dtype=float)
    n = len(requests)
    n_completed_before = len(engine.completed)
    preempts_before = engine.stats().get("n_preempts", 0)
    t0 = time.perf_counter()
    i = 0
    steps = 0
    while True:
        now = time.perf_counter() - t0
        while i < n and offs[i] <= now:
            engine.submit(requests[i])
            i += 1
        busy = engine.step()
        steps += 1
        if steps >= max_steps:
            raise RuntimeError(f"not drained after {max_steps} steps")
        drained = not (engine.sched.n_pending or engine.prefilling
                       or engine.active)
        if i >= n and drained:
            break
        if not busy and i < n:
            # idle until the next arrival (a bounded nap keeps
            # sub-millisecond schedules responsive)
            wait = offs[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 1e-3))
    wall = time.perf_counter() - t0
    comps = list(engine.completed[n_completed_before:])
    ttfts = [c.ttft for c in comps]
    itls = [d for c in comps for d in c.itl]
    met = [c for c in comps if _request_meets_slo(c, slo_ttft_s, slo_itl_s)]
    p99_ttft = float(np.percentile(ttfts, 99)) if ttfts else 0.0
    p99_itl = float(np.percentile(itls, 99)) if itls else 0.0
    sustained: Optional[bool] = None
    if slo_ttft_s is not None or slo_itl_s is not None:
        sustained = ((slo_ttft_s is None or p99_ttft <= slo_ttft_s)
                     and (slo_itl_s is None or p99_itl <= slo_itl_s))
    offered_span = float(offs[-1]) if n else 0.0
    return OpenLoopResult(
        n_requests=n,
        n_completed=len(comps),
        wall_s=wall,
        offered_qps=(n / offered_span) if offered_span > 0 else 0.0,
        completed_qps=(len(comps) / wall) if wall > 0 else 0.0,
        goodput_qps=(len(met) / wall) if wall > 0 else 0.0,
        slo_attainment=(len(met) / n) if n else 0.0,
        p50_ttft_s=float(np.percentile(ttfts, 50)) if ttfts else 0.0,
        p99_ttft_s=p99_ttft,
        p99_itl_s=p99_itl,
        slo_ttft_s=slo_ttft_s,
        slo_itl_s=slo_itl_s,
        sustained=sustained,
        n_preempts=int(engine.stats().get("n_preempts", 0)
                       - preempts_before),
        completions=comps,
    )
