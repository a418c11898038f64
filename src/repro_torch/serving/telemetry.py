"""Structured serving telemetry (port of `repro.serving.telemetry`;
DESIGN.md §Observability).

Three layers of observability for the engine, all OFF by default and
all bit-neutral by construction:

  request-lifecycle trace: typed events (`EVENT_FIELDS`) carrying
  monotonic host timestamps and request / slot / page context,
  buffered as plain dicts and exported as JSONL (DESIGN.md
  §Observability ¶Event schema).  The schema table is a copy of the
  reference's, so a port trace passes `tools/trace_summary.py`.

  step-phase spans: a context-manager span per engine-step phase
  (`PHASES`), folded into one record a step together with the
  dispatch-shape counters and the arena's gauges (DESIGN.md
  §Observability ¶Span model).

  profiler hooks: `annotate()` returns
  `torch.profiler.record_function(name)` when `profile_annotations`
  is on, so a profile's ranges line up with the host-side spans; the
  shared no-op context otherwise.

Bit-neutrality (DESIGN.md §Observability ¶Bit-neutrality): every hook
reads host state only (wall-clock stamps, Python counters, the host
page table), never a device value: no `.item()`, no sync, no extra
launch.  Telemetry-on and telemetry-off engines therefore give equal
tokens.

The default is the `NullTelemetry` singleton (`NULL`): every hook a
no-op, every buffer an empty tuple.

`dispatch(kind, key)` counts the dispatch shapes the engine issues: the
first sighting of a (kind, key) is a "miss", every later one a "hit".
The port compiles nothing per shape (its kernels build once, at first
use), so the counters here record which shapes a window met, in the
reference's terms: a warmed engine's window reads all hits.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

# The event schema: kind -> required payload fields.  Every event also
# carries "t" (monotonic seconds, time.perf_counter) and, when emitted
# inside an engine step, "step".  Kinds this slice never emits
# (preemption, prefix cache) are kept so the table stays the
# reference's.
EVENT_FIELDS: Dict[str, frozenset] = {
    "submit": frozenset({"req_id", "prompt_len", "max_new_tokens"}),
    "admit": frozenset({"req_id", "slot"}),
    "admit_reject": frozenset({"req_id", "reason"}),
    "prefill_chunk": frozenset({"req_id", "slot", "start", "end", "pages"}),
    "first_token": frozenset({"req_id", "slot", "token"}),
    "emit": frozenset({"req_id", "slot", "token"}),
    "preempt": frozenset({"req_id", "slot", "reason", "n_generated"}),
    "resume": frozenset({"req_id", "slot", "n_preempts"}),
    "prefix_hit": frozenset({"req_id", "slot", "pages", "tokens"}),
    "prefix_miss": frozenset({"req_id", "slot"}),
    "cow_split": frozenset({"req_id", "slot", "old_page", "new_page"}),
    "finish": frozenset({"req_id", "slot", "reason", "n_generated"}),
}

# The engine-step phases a span may time (DESIGN.md §Observability
# ¶Span model).  The port's engine runs the chunked path only, so it
# times `admission`, `plan_chunks`, `unified_dispatch` and `harvest`;
# `decode_dispatch` belongs to the reference's whole-prompt modes.
PHASES: Tuple[str, ...] = (
    "admission",
    "plan_chunks",
    "unified_dispatch",
    "decode_dispatch",
    "harvest",
)


class _NullCtx:
    """Reusable no-op context manager (singleton `_NULL_CTX`)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTelemetry:
    """The off-by-default sink: every hook a no-op, every buffer an
    empty tuple.  One shared instance (`NULL`) serves every engine."""

    enabled = False
    events: tuple = ()
    steps: tuple = ()
    compile_hits = 0
    compile_misses = 0

    def begin_step(self, idx: int):
        pass

    def end_step(self, **gauges):
        pass

    def span(self, phase: str):
        return _NULL_CTX

    def event(self, kind: str, **fields):
        pass

    def dispatch(self, kind: str, key):
        pass

    def annotate(self, name: str):
        return _NULL_CTX

    def clear(self):
        pass


NULL = NullTelemetry()


class _Span:
    """Times one phase of the current step; re-entry within a step
    accumulates."""

    __slots__ = ("tel", "phase", "t0")

    def __init__(self, tel: "Telemetry", phase: str):
        self.tel = tel
        self.phase = phase

    def __enter__(self):
        self.t0 = self.tel.clock()
        return self

    def __exit__(self, *exc):
        cur = self.tel._cur
        if cur is not None:
            ph = cur["phases"]
            ph[self.phase] = (
                ph.get(self.phase, 0.0) + self.tel.clock() - self.t0)
        return False


class Telemetry:
    """Buffering telemetry sink (DESIGN.md §Observability).

    Events and step records accumulate as plain dicts; nothing is
    serialized until `export_trace` / `export_metrics`.
    `ServingEngine.reset_stats()` clears the buffers with the run
    statistics; the dispatch-shape seen-set survives `clear()`, so
    shapes a warmup issued count as hits in the measured window.
    """

    enabled = True

    def __init__(self, *, profile_annotations: bool = False):
        self.profile_annotations = bool(profile_annotations)
        self.clock = time.perf_counter
        self.events: List[dict] = []
        self.steps: List[dict] = []
        self.compile_hits = 0
        self.compile_misses = 0
        self._seen_shapes: Set[tuple] = set()
        self._cur: Optional[dict] = None
        self._step_idx: Optional[int] = None
        # one reusable span per phase (phases never nest with
        # themselves and the engine is single-threaded)
        self._spans: Dict[str, _Span] = {}

    # -- lifecycle events ----------------------------------------------
    def event(self, kind: str, **fields):
        """Record one typed event, stamped with the monotonic clock
        (and the current step index inside a step)."""
        rec: Dict[str, Any] = {"event": kind, "t": self.clock()}
        if self._step_idx is not None:
            rec["step"] = self._step_idx
        rec.update(fields)
        self.events.append(rec)

    # -- step spans + gauges -------------------------------------------
    def begin_step(self, idx: int):
        self._step_idx = idx
        self._cur = {"step": idx, "t": self.clock(), "phases": {}}

    def span(self, phase: str):
        """Context manager timing `phase` of the current step."""
        s = self._spans.get(phase)
        if s is None:
            s = self._spans[phase] = _Span(self, phase)
        return s

    def end_step(self, **gauges):
        """Close the step record, folding in the engine's gauges."""
        cur = self._cur
        if cur is None:
            return
        cur["wall_s"] = self.clock() - cur["t"]
        cur["compile_hits"] = self.compile_hits
        cur["compile_misses"] = self.compile_misses
        cur.update(gauges)
        self.steps.append(cur)
        self._cur = None
        self._step_idx = None

    # -- dispatch-shape counters ---------------------------------------
    def dispatch(self, kind: str, key):
        """Account one dispatch of shape `key`: the first sighting of a
        (kind, key) is a miss, every later one a hit."""
        k = (kind, tuple(key))
        if k in self._seen_shapes:
            self.compile_hits += 1
        else:
            self._seen_shapes.add(k)
            self.compile_misses += 1

    # -- profiler hooks ------------------------------------------------
    def annotate(self, name: str):
        """`torch.profiler.record_function(name)` when profiler hooks
        are on, else the shared no-op context."""
        if not self.profile_annotations:
            return _NULL_CTX
        return torch.profiler.record_function(name)

    # -- export --------------------------------------------------------
    def clear(self):
        """Drop buffered events / steps and zero the hit and miss
        counters (the seen-set survives; see the class doc)."""
        self.events.clear()
        self.steps.clear()
        self.compile_hits = 0
        self.compile_misses = 0
        self._cur = None
        self._step_idx = None

    def metrics(self) -> dict:
        """Aggregate the step records: per-phase totals and means, the
        dispatch-shape counters and the raw per-step series."""
        phase_s: Dict[str, float] = {}
        phase_n: Dict[str, int] = {}
        for s in self.steps:
            for ph, v in s["phases"].items():
                phase_s[ph] = phase_s.get(ph, 0.0) + v
                phase_n[ph] = phase_n.get(ph, 0) + 1
        return {
            "n_steps": len(self.steps),
            "n_events": len(self.events),
            "phase_total_s": phase_s,
            "phase_mean_s": {ph: phase_s[ph] / phase_n[ph]
                             for ph in phase_s},
            "compile_hits": self.compile_hits,
            "compile_misses": self.compile_misses,
            "steps": self.steps,
        }

    def export_trace(self, path: str):
        """Write the event buffer as JSONL (one event per line), the
        format tools/trace_summary.py reads."""
        with open(path, "w") as f:
            for rec in self.events:
                f.write(json.dumps(rec) + "\n")

    def export_metrics(self, path: str):
        """Write the aggregated step metrics as one JSON document."""
        with open(path, "w") as f:
            json.dump(self.metrics(), f, indent=2)
            f.write("\n")
