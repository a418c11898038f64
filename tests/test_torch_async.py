"""The port's async dispatch (depth 1) against the JAX reference's.

At `dispatch_depth=1` the engine leaves one unified step in flight:
each `step()` plans (policy, preemption, admission) while the previous
step runs, then harvests it, materializes its chunk rows and dispatches
the next.  The reference engine runs `ServingEngine(paged=True,
paged_kernel=False, dispatch_depth=1)`; the port runs its engine on
the CPU; both get the same deployed tables (reduced granite_3_2b) and
the same requests.  Stepped in lockstep, they must agree after every
step (progress flag, in-flight count, page tables, refcounts) and
after the drain on tokens, finish reasons, completion order,
`n_preempts`, steps, every non-timing `stats()` key, the trace and the
step records (all but the clock).  Held under FCFS, under the
reference's scripted preemptions (`tests/test_policy.py`, whose plans
drain the in-flight step before evicting) and with the prefix cache
on, at kv_bits 8 and 4; and depth 1's tokens equal depth 0's.
"""
import jax
import numpy as np
import pytest

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine, Telemetry as JTelemetry,
)
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    DispatchQueue, SchedulerConfig, ServingConfig, ServingEngine, Telemetry,
)
from test_policy import ScriptedPreemptions

MAX_LEN = 40
PS = 8
# (prompt length, new tokens): long prompts at chunk 4 stay mid-prefill
# across several steps (the scripted "prefilling" eviction needs one)
SPECS = [(14, 8), (6, 10), (18, 6), (9, 9), (5, 7), (12, 4)]
SCRIPT = {3: "prefilling", 6: "active", 10: "active", 15: "active"}


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _engine(models, port: bool, depth=1, *, policy=None, telemetry=None,
            **kw):
    jlm, jt, tlm, tt = models
    kw = dict(n_slots=2, max_len=MAX_LEN, page_size=PS,
              dispatch_depth=depth, policy=policy, telemetry=telemetry,
              **kw)
    if port:
        return ServingEngine(tlm, tt, ServingConfig(
            device="cpu", paged=True,
            scheduler=SchedulerConfig(prefill_chunk=4), **kw))
    return JServingEngine(jlm, jt, JServingConfig(
        paged=True, paged_kernel=False,
        scheduler=JSchedulerConfig(prefill_chunk=4), **kw))


def _prompts(vocab, case):
    rng = np.random.default_rng(13)
    if case != "prefix":
        return [rng.integers(0, vocab, size=(p,)) for p, _ in SPECS]
    # one 16-token system prompt (two full pages), suffixes of 0-5
    # tokens: hits, an aligned-exact twin and its copy-on-write split
    pre = rng.integers(0, vocab, size=(16,))
    return [np.concatenate([pre, rng.integers(0, vocab, size=(n,))])
            for n in (5, 3, 0, 4, 1, 2)]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


_TIMED = {"t", "wall_s", "phases"}


def _lockstep(j, t, prompts):
    """Submit two, step, submit the rest, then step both engines
    together to the drain, comparing the host state after every step;
    -> the port's completions."""
    gens = [g for _, g in SPECS]
    for eng in (j, t):
        for p, g in zip(prompts[:2], gens[:2]):
            eng.submit(np.asarray(p), max_new_tokens=g)
    assert j.step() == t.step()
    for eng in (j, t):
        for p, g in zip(prompts[2:], gens[2:]):
            eng.submit(np.asarray(p), max_new_tokens=g)
    steps = 0
    while j.queue.pending or j.sched.n_pending or j.prefilling or j.active:
        assert j.step() == t.step()
        assert t.queue.pending == j.queue.pending <= 1
        np.testing.assert_array_equal(t.arena.page_table, j.arena.page_table)
        np.testing.assert_array_equal(t.arena.refcount, j.arena.refcount)
        steps += 1
        assert steps < 400
    assert not (t.queue.pending or t.sched.n_pending or t.prefilling
                or t.active)
    key = [(c.req_id, list(map(int, c.tokens)), c.finish_reason,
            c.n_preempts) for c in j.completed]
    assert [(c.req_id, list(map(int, c.tokens)), c.finish_reason,
             c.n_preempts) for c in t.completed] == key
    return t.completed


CASES = [("fcfs", 8), ("fcfs", 4), ("scripted", 8), ("scripted", 4),
         ("prefix", 8), ("prefix", 4)]


@pytest.fixture(scope="module")
def runs(models):
    """Per case: the reference and the port stepped in lockstep at
    depth 1 (telemetry on), and the port at depth 0 for the tokens."""
    out = {}
    vocab = models[2].cfg.vocab
    for case, kv_bits in CASES:
        kw = dict(kv_bits=kv_bits)
        if case == "prefix":
            kw.update(prefix_cache=True, cache_keep_pages=8)
        pols = [ScriptedPreemptions(SCRIPT) if case == "scripted" else None
                for _ in range(3)]
        jtel, ttel = JTelemetry(), Telemetry()
        j = _engine(models, False, policy=pols[0], telemetry=jtel, **kw)
        t = _engine(models, True, policy=pols[1], telemetry=ttel, **kw)
        prompts = _prompts(vocab, case)
        done = _lockstep(j, t, prompts)
        sync = _engine(models, True, 0, policy=pols[2], **kw)
        for p, (_, g) in zip(prompts, SPECS):
            sync.submit(np.asarray(p), max_new_tokens=g)
        out[(case, kv_bits)] = dict(
            j=j, t=t, jtel=jtel, ttel=ttel, done=done, pols=pols,
            sync={c.req_id: list(c.tokens)
                  for c in sync.run_until_drained()})
    return out


@pytest.mark.parametrize("case,kv_bits", CASES)
def test_depth1_lockstep_with_reference(runs, case, kv_bits):
    r = runs[(case, kv_bits)]
    j, t = r["j"], r["t"]
    assert len(r["done"]) == len(SPECS)
    js, ts = _plain(j.stats()), _plain(t.stats())
    assert ts["dispatch_depth"] == js["dispatch_depth"] == 1
    for k, v in js.items():
        if k.endswith("_s") or k in ("wall_s", "throughput_tok_s"):
            assert isinstance(ts[k], float) and ts[k] >= 0.0, k
        else:
            assert ts[k] == v, k
    if case == "scripted":
        jp, tp = r["pols"][0], r["pols"][1]
        assert tp.n_scripted == jp.n_scripted >= 3
        assert ts["n_preempts"] == tp.n_scripted
    if case == "prefix":
        assert ts["prefix_hits"] >= 1 and ts["cow_splits"] >= 1


@pytest.mark.parametrize("case,kv_bits", CASES)
def test_depth1_trace_and_step_records_equal_reference(runs, case,
                                                       kv_bits):
    """Every event but its clock, and every step record but its timings
    (the queue depth included: 1 while a step is in flight)."""
    r = runs[(case, kv_bits)]
    jev, tev = _plain(r["jtel"].events), _plain(r["ttel"].events)
    assert [{k: v for k, v in e.items() if k != "t"} for e in tev] == [
        {k: v for k, v in e.items() if k != "t"} for e in jev]
    jst, tst = _plain(r["jtel"].steps), _plain(r["ttel"].steps)
    assert len(tst) == len(jst) == r["t"].stats()["steps"]
    for p, q in zip(tst, jst):
        assert p["phases"].keys() == q["phases"].keys()
        assert {k: v for k, v in p.items() if k not in _TIMED} == {
            k: v for k, v in q.items() if k not in _TIMED}
    assert {s["queue_depth"] for s in tst} == {0, 1}
    seen = set().union(*(s["phases"] for s in tst))
    assert seen == {"admission", "plan_chunks", "unified_dispatch",
                    "harvest"}
    if case == "scripted":
        assert {e["event"] for e in tev} >= {"preempt", "resume"}


@pytest.mark.parametrize("case,kv_bits", CASES)
def test_depth1_tokens_equal_depth0(runs, case, kv_bits):
    r = runs[(case, kv_bits)]
    assert {c.req_id: list(c.tokens) for c in r["done"]} == r["sync"]


def test_dispatch_depth_2_raises():
    for depth in (2, -1):
        with pytest.raises(ValueError, match="dispatch_depth"):
            ServingConfig(dispatch_depth=depth)
        with pytest.raises(ValueError, match="dispatch_depth"):
            DispatchQueue(depth)
        with pytest.raises(ValueError):
            JServingConfig(dispatch_depth=depth)
    assert ServingConfig().dispatch_depth == 0


def test_queue_holds_one_step_and_drains_oldest_first():
    q = DispatchQueue(1)
    q.push("a")
    with pytest.raises(RuntimeError, match="overfilled"):
        q.push("b")
    got = []
    q.drain(got.append)
    assert got == ["a"] and q.pending == 0
    q0 = DispatchQueue(0)
    q0.push("x")  # depth 0 still carries the one record it harvests
    with pytest.raises(RuntimeError):
        q0.push("y")


def test_no_step_left_in_flight(models):
    """A step in flight makes the engine busy: warmup and reset_stats
    refuse, as the reference's do; run_until_drained harvests it and
    leaves nothing in flight, after which both are allowed."""
    vocab = models[2].cfg.vocab
    for port in (False, True):
        eng = _engine(models, port)
        eng.submit(np.arange(5) % vocab, max_new_tokens=3)
        assert eng.step() and eng.queue.pending == 1
        with pytest.raises(RuntimeError):
            eng.warmup()
        with pytest.raises(RuntimeError):
            eng.reset_stats()
        done = eng.run_until_drained()
        assert len(done) == 1 and len(done[0].tokens) == 3
        assert eng.queue.pending == 0
        eng.reset_stats()
        eng.warmup()
        assert eng.queue.pending == 0


def test_cli_dispatch_depth_1(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--gen", "3",
                "--max-len", "16", "--paged", "--page-size", "4",
                "--prefill-chunk", "4", "--dispatch-depth", "1"])
    out = capsys.readouterr().out
    assert "drained 3 requests / 9 tokens" in out
    assert '"dispatch_depth": 1' in out
