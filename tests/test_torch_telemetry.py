"""The port's telemetry, warmup, reset_stats and full stats() against the
JAX reference's, at tolerance 0.

The reference runs `ServingEngine(paged=True, paged_kernel=False)` (its
paged arena with chunked prefill through the write-then-gather path,
which runs under this jax); the port runs its engine on the CPU.  Both
get the same deployed tables (reduced granite_3_2b), the same requests
and the same submit / step sequence, so everything the telemetry
records from host state (event kinds and payloads, step indices, page
ids, gauges, dispatch-shape counters) must agree; only the clock
stamps may differ.
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine, Telemetry as JTelemetry,
)
from repro.serving.request import Completion as JCompletion
from repro.serving.telemetry import (
    EVENT_FIELDS as J_EVENT_FIELDS, PHASES as J_PHASES,
)
from repro_torch.configs.base import get_config
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    NULL, SchedulerConfig, ServingConfig, ServingEngine, Telemetry,
)
from repro_torch.serving.request import Completion
from repro_torch.serving.telemetry import _NULL_CTX, EVENT_FIELDS, PHASES

MAX_LEN = 40
# (prompt length, new tokens): prompts inside one chunk, across chunks
# and pages, a 1-token prompt; page 8, chunk 4
SPECS = [(8, 6), (3, 4), (12, 5), (1, 3), (8, 4), (5, 6), (17, 3)]
# (n_slots, n_pages): 3 slots over 6 pages block admission on the page
# budget and on the slots (admit_reject events of both reasons)
N_SLOTS, N_PAGES = 3, 6


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _workload(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(p,)), g) for p, g in SPECS]


def _engine(models, port: bool, *, telemetry=None, kv_bits=8,
            n_pages=N_PAGES):
    jlm, jt, tlm, tt = models
    if port:
        return ServingEngine(tlm, tt, ServingConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, page_size=8, n_pages=n_pages,
            device="cpu", kv_bits=kv_bits, telemetry=telemetry,
            scheduler=SchedulerConfig(prefill_chunk=4)))
    return JServingEngine(jlm, jt, JServingConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, paged=True, page_size=8,
        n_pages=n_pages, paged_kernel=False, kv_bits=kv_bits,
        telemetry=telemetry,
        scheduler=JSchedulerConfig(prefill_chunk=4)))


def _drive(eng, workload):
    """Submit and step once per request (arrivals interleaved with
    decoding), drain; -> tokens in submit order."""
    ids = []
    for prompt, g in workload:
        ids.append(eng.submit(prompt, max_new_tokens=g))
        eng.step()
    done = {c.req_id: list(c.tokens) for c in eng.run_until_drained()}
    return [done[i] for i in ids]


def _plain(x):
    """numpy scalars -> Python ones, recursively (for equality)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _session(eng, tel, workload):
    """warmup, a first window, reset_stats, a second window: what each
    engine recorded at each point."""
    out = {}
    eng.warmup()
    out["warm_counts"] = (tel.compile_hits, tel.compile_misses)
    out["tokens"] = _drive(eng, workload)
    out["events"] = [_plain(e) for e in tel.events]
    out["steps"] = [_plain(s) for s in tel.steps]
    out["stats"] = _plain(eng.stats())
    out["counts"] = (tel.compile_hits, tel.compile_misses)
    out["metrics"] = tel.metrics()
    eng.reset_stats()
    out["reset_stats"] = _plain(eng.stats())
    out["reset_buffers"] = (list(tel.events), list(tel.steps),
                            tel.compile_hits, tel.compile_misses)
    out["tokens2"] = _drive(eng, workload)
    out["counts2"] = (tel.compile_hits, tel.compile_misses)
    out["stats2"] = _plain(eng.stats())
    return out


@pytest.fixture(scope="module")
def runs(models):
    w = _workload(models[2].cfg.vocab)
    jtel, ttel = JTelemetry(), Telemetry()
    ref = _session(_engine(models, False, telemetry=jtel), jtel, w)
    port = _session(_engine(models, True, telemetry=ttel), ttel, w)
    off_eng = _engine(models, True)
    off = {"tokens": _drive(off_eng, w), "engine": off_eng}
    return ref, port, off, ttel


def test_telemetry_on_off_and_reference_give_equal_tokens(runs):
    ref, port, off, _ = runs
    assert port["tokens"] == off["tokens"] == ref["tokens"]
    assert port["tokens2"] == ref["tokens2"] == ref["tokens"]
    assert [len(t) for t in port["tokens"]] == [g for _, g in SPECS]


def test_telemetry_off_records_nothing(runs):
    _, _, off, _ = runs
    eng = off["engine"]
    assert eng.tel is NULL and not eng.tel.enabled
    assert eng.tel.events == () and eng.tel.steps == ()
    assert NULL.span("admission") is _NULL_CTX
    assert NULL.annotate("x") is _NULL_CTX


def test_schema_tables_equal_reference():
    assert EVENT_FIELDS == J_EVENT_FIELDS
    assert PHASES == J_PHASES


def test_trace_equals_reference_but_the_clock(runs):
    """Every event, in order: kind, step index, req_id, slot, tokens,
    chunk spans, pages, reject reasons, finish reasons; only `t`
    differs."""
    ref, port, _, _ = runs

    def no_t(evs):
        return [{k: v for k, v in e.items() if k != "t"} for e in evs]

    assert no_t(port["events"]) == no_t(ref["events"])
    kinds = {e["event"] for e in port["events"]}
    assert kinds == {"submit", "admit", "admit_reject", "prefill_chunk",
                     "first_token", "emit", "finish"}
    assert {e["reason"] for e in port["events"]
            if e["event"] == "admit_reject"} == {"no_pages", "no_slot"}
    ts = [e["t"] for e in port["events"]]
    assert ts == sorted(ts)


def _trace_summary():
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "trace_summary.py")
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_passes_trace_summary(runs, tmp_path):
    _, port, _, ttel = runs
    ts = _trace_summary()
    path = tmp_path / "trace.jsonl"
    ttel.export_trace(str(path))  # the second window's trace
    assert ts.load_trace(str(path)) == [_plain(e) for e in ttel.events]
    tel = Telemetry()
    tel.events.extend(port["events"])
    tel.export_trace(str(path))  # the first window's
    events = ts.load_trace(str(path))
    ts.validate(events)
    reqs = ts.lifecycles(events)
    assert len(reqs) == len(SPECS)
    for r in reqs.values():
        assert r["ttft_s"] > 0.0 and r["decode_s"] >= 0.0
    assert ts.summarize(events, reqs)


def test_step_records_equal_reference_but_the_clock(runs):
    """Each step record has the reference's keys, its phase keys and
    its gauges' values (queue depth, pending / active / prefilling,
    rejects, the arena's gauges, the dispatch-shape counters)."""
    ref, port, _, _ = runs
    assert len(port["steps"]) == len(ref["steps"]) > 0
    timed = {"t", "wall_s", "phases"}
    for p, r in zip(port["steps"], ref["steps"]):
        assert p.keys() == r.keys()
        assert p["phases"].keys() == r["phases"].keys()
        assert {k: v for k, v in p.items() if k not in timed} == {
            k: v for k, v in r.items() if k not in timed}
        assert all(v >= 0.0 for v in p["phases"].values())
    seen = set().union(*(p["phases"] for p in port["steps"]))
    assert seen == {"admission", "plan_chunks", "unified_dispatch",
                    "harvest"}
    m = port["metrics"]
    assert m["n_steps"] == len(port["steps"])
    assert set(m["phase_mean_s"]) == seen == set(
        ref["metrics"]["phase_mean_s"])


def test_dispatch_counters_after_warmup_equal_reference(runs):
    """warmup registers both widths (2 misses); the window after it is
    all hits, and after reset_stats the counters restart at 0 with the
    seen-set kept, so the second window is all hits too."""
    ref, port, _, _ = runs
    assert port["warm_counts"] == ref["warm_counts"] == (0, 2)
    assert port["counts"] == ref["counts"]
    assert port["counts"][1] == 2 and port["counts"][0] > 0
    assert port["counts2"] == ref["counts2"]
    assert port["counts2"][1] == 0


# stats() keys whose values are timings (they may differ) or describe
# the port's own arena
_TIMED = ("wall_s", "throughput_tok_s")


def test_stats_keys_and_counters_equal_reference(runs):
    ref, port, _, _ = runs
    for key in ("stats", "stats2"):
        p, r = port[key], ref[key]
        assert set(p) >= set(r)
        for k, v in r.items():
            if k in _TIMED or k.endswith("_s"):
                assert isinstance(p[k], float) and p[k] >= 0.0, k
            else:
                assert p[k] == v, k
        assert p["pool_bytes"] > 0 and p["device"] == "cpu"
    s = port["stats"]
    assert s["n_preempts"] == 0 and s["dispatch_depth"] == 0
    assert s["mesh_devices"] == 1 and s["kv_shard"] is False
    assert s["p50_ttft_s"] <= s["p95_ttft_s"] <= s["p99_ttft_s"] \
        <= s["max_ttft_s"]
    assert s["p50_itl_s"] <= s["p95_itl_s"] <= s["p99_itl_s"]


def test_reset_stats_zeroes_the_window(runs):
    ref, port, _, _ = runs
    assert port["reset_buffers"] == ([], [], 0, 0)
    p, r = port["reset_stats"], ref["reset_stats"]
    for k in ("n_completed", "n_generated", "steps", "admit_rejects",
              "max_active", "wall_s", "mean_ttft_s", "p99_itl_s"):
        assert p[k] == r[k] == 0, k
    # the page peaks restart from the (idle) arena
    assert p["max_pages_in_use"] == r["max_pages_in_use"] == 0
    assert p["max_committed_pages"] == r["max_committed_pages"] == 0


def _pools(eng, port: bool):
    if port:
        return [eng.arena.caches[kv].clone().numpy() for kv in ("k", "v")]
    return [np.asarray(eng.arena.caches[0][kv]) for kv in ("k", "v")]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_warmup_leaves_the_pools_byte_equal(models, kv_bits):
    """After a drained workload (stale pages in the pools), warmup
    leaves every page a request can hold byte-equal.  Its parked rows
    write only the PAGE_NULL trash page (page 0), as every step's
    parked rows do, and that page equals the reference's after its
    warmup."""
    w = _workload(models[2].cfg.vocab, seed=5)
    pools = {}
    for port in (True, False):
        eng = _engine(models, port, kv_bits=kv_bits, n_pages=16)
        _drive(eng, w)
        before = _pools(eng, port)
        eng.warmup()
        after = _pools(eng, port)
        for b, a in zip(before, after):
            assert a.shape[1] == 17
            np.testing.assert_array_equal(a[:, 1:], b[:, 1:])
        pools[port] = after
        assert eng.stats()["n_completed"] == len(SPECS)
    for a, b in zip(pools[True], pools[False]):
        np.testing.assert_array_equal(a, b)


def test_warmup_and_reset_stats_refuse_a_busy_engine(models):
    for port in (True, False):
        eng = _engine(models, port)
        eng.submit(np.arange(5), max_new_tokens=2)
        with pytest.raises(RuntimeError, match="non-idle"):
            eng.warmup()
        with pytest.raises(RuntimeError, match="non-idle"):
            eng.reset_stats()


def test_exports_round_trip(runs, tmp_path):
    _, port, _, _ = runs
    tel = Telemetry()
    tel.events.extend(port["events"])
    tel.steps.extend(port["steps"])
    tel.compile_hits, tel.compile_misses = port["counts"]
    trace, metrics = tmp_path / "trace.jsonl", tmp_path / "metrics.json"
    tel.export_trace(str(trace))
    tel.export_metrics(str(metrics))
    lines = trace.read_text().splitlines()
    assert [json.loads(x) for x in lines] == port["events"]
    m = json.loads(metrics.read_text())
    assert m == json.loads(json.dumps(tel.metrics()))
    assert m["n_steps"] == len(port["steps"])
    assert m["n_events"] == len(port["events"])
    assert set(m["phase_mean_s"]) <= set(PHASES)
    assert _trace_summary().summarize_metrics(str(metrics))


def test_profile_annotations_are_record_function_ranges(models):
    """profile_annotations=True wraps each dispatch in a
    torch.profiler.record_function range; the tokens are unchanged and
    a CPU profile of the run carries the range once per step."""
    w = _workload(models[2].cfg.vocab)[:3]
    plain = _drive(_engine(models, True), w)
    tel = Telemetry(profile_annotations=True)
    eng = _engine(models, True, telemetry=tel)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        annotated = _drive(eng, w)
    assert annotated == plain
    assert isinstance(tel.annotate("x"), torch.profiler.record_function)
    assert Telemetry().annotate("x") is _NULL_CTX
    n = sum(e.count for e in prof.key_averages()
            if e.key == "repro_torch.serving/unified")
    assert n == eng.stats()["steps"] > 0


def test_completion_breakdown_equals_reference():
    kw = dict(req_id=0, prompt_len=4, tokens=[1, 2, 3],
              finish_reason="length", arrival_time=1.0,
              first_token_time=3.0, finish_time=6.5, admit_time=2.25,
              emit_times=[3.0, 4.5, 6.5])
    c, j = Completion(**kw), JCompletion(**kw)
    for k in ("ttft", "latency", "itl", "queued_s", "prefill_s",
              "decode_s"):
        assert getattr(c, k) == getattr(j, k), k
    assert c.queued_s + c.prefill_s + c.decode_s == c.latency
