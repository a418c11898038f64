"""Continuous-batching integer serving (port of `repro.serving`:
`SlotArena` and `PagedArena`, the chunked, bucketed and exact prefill
modes, synchronous or one step deep (`DispatchQueue`), int8 or
int4-packed KV,
the prefix cache with copy-on-write and warm pages, FCFS and
`PrioritySLOPolicy` with bit-exact preemption, telemetry, the
open-loop load generator, and either arena kv-sharded over a serving
mesh)."""
from repro_torch.layers.attention import INACTIVE_POS, PAGE_NULL
from repro_torch.serving.cache import (
    PagedArena, SlotArena, assert_integer_caches, float_cache_leaves,
    make_arena,
)
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import DispatchQueue, ServingEngine
from repro_torch.serving.loadgen import (
    OpenLoopResult, poisson_arrivals, run_open_loop, shared_prefix_workload,
    trace_arrivals,
)
from repro_torch.serving.policy import (
    EngineView, FCFSPolicy, PrioritySLOPolicy, SchedulingPolicy, StepPlan,
    make_policy,
)
from repro_torch.serving.request import Completion, Request, ResumeState
from repro_torch.serving.scheduler import SchedulerConfig, Scheduler
from repro_torch.serving.telemetry import NULL, NullTelemetry, Telemetry
