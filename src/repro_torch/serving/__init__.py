"""Continuous-batching integer serving over the paged arena (port of
`repro.serving`: the default FCFS / synchronous / chunked path, int8
or int4-packed KV, telemetry and the open-loop load generator)."""
from repro_torch.layers.attention import INACTIVE_POS, PAGE_NULL
from repro_torch.serving.cache import PagedArena
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.loadgen import (
    OpenLoopResult, poisson_arrivals, run_open_loop, shared_prefix_workload,
    trace_arrivals,
)
from repro_torch.serving.policy import (
    EngineView, FCFSPolicy, SchedulingPolicy, StepPlan,
)
from repro_torch.serving.request import Completion, Request
from repro_torch.serving.scheduler import SchedulerConfig, Scheduler
from repro_torch.serving.telemetry import NULL, NullTelemetry, Telemetry
