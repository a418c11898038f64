"""The port's preemption and `PrioritySLOPolicy` against the JAX
reference's, at tolerance 0.

The reference runs `ServingEngine(paged=True, paged_kernel=False)` (its
paged arena through the write-then-gather attention path, which runs
under this jax); the port runs its engine on the CPU, both on the same
deployed tables (reduced granite_3_2b).  Scripted evictions come from
`tests/test_policy.py`'s `ScriptedPreemptions` and
`tests/test_starvation_proof.py`'s `ScriptedEvictions`, the same class
driving both engines (the port's snapshots carry the reference's
names).  Held here:

  - preempt / resume token parity at kv_bits 8 and 4, cache off and
    on, lockstep with the reference (page tables after every step,
    `n_preempts`, completions' `n_preempts`, pools after the drain);
  - no page leak over repeated rounds;
  - `PrioritySLOPolicy`'s plans on hand-built views equal the
    reference policy's (admission order, LIFO lowest-class eviction,
    rollback on shortfall, aging that changes order only, the
    no-preempt flag, chunk packing), each policy on each side's view;
  - the organic overload case and the preempt / resume trace;
  - a starvation fuzz over fixed seeds (plain parametrisation): the
    ledger invariant after every step (committed + pinned <= n_pages,
    page and slot conservation, no negative refcount), every request
    finished, and tokens equal to the reference's.
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    FCFSPolicy as JFCFSPolicy, PrioritySLOPolicy as JPrioritySLOPolicy,
    Request as JRequest, SchedulerConfig as JSchedulerConfig,
    ServingConfig as JServingConfig, ServingEngine as JServingEngine,
    Telemetry as JTelemetry,
)
from repro.serving import policy as jpolicy
from repro_torch.configs.base import get_config
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    FCFSPolicy, PrioritySLOPolicy, Request, SchedulerConfig, SchedulingPolicy,
    ServingConfig, ServingEngine, Telemetry, make_policy,
)
from repro_torch.serving import policy as tpolicy
from test_policy import ScriptedPreemptions
from test_starvation_proof import ScriptedEvictions, _assert_ledger


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_LEN = 40
PS = 8


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _engine(models, port: bool, *, chunk=4, max_len=MAX_LEN, policy=None,
            telemetry=None, **kw):
    jlm, jt, tlm, tt = models
    if port:
        return ServingEngine(tlm, tt, ServingConfig(
            max_len=max_len, paged=True, page_size=PS, device="cpu",
            policy=policy,
            telemetry=telemetry,
            scheduler=SchedulerConfig(prefill_chunk=chunk), **kw))
    return JServingEngine(jlm, jt, JServingConfig(
        max_len=max_len, paged=True, page_size=PS, paged_kernel=False,
        policy=policy, telemetry=telemetry,
        scheduler=JSchedulerConfig(prefill_chunk=chunk), **kw))


def _pair(models, policy=None, **kw):
    """(reference, port) engines; `policy` a factory called per engine."""
    return tuple(_engine(models, port, policy=policy() if policy else None,
                         **kw) for port in (False, True))


def _busy(eng):
    return bool(eng.sched.n_pending or eng.prefilling or eng.active)


def _submit(eng, prompts, gens, prios=None):
    prios = prios or [0] * len(prompts)
    return [eng.submit(np.asarray(p), max_new_tokens=g, priority=pr)
            for p, g, pr in zip(prompts, gens, prios)]


def _lockstep(j, t, prompts, gens, prios=None):
    """Both engines over the same requests, stepped together with their
    page tables and refcounts equal after every step; -> the port's
    completions by req_id (tokens, finish reasons and n_preempts equal
    to the reference's)."""
    n0 = len(t.completed)
    for eng in (j, t):
        _submit(eng, prompts, gens, prios)
    steps = 0
    while _busy(j) or _busy(t):
        assert j.step() == t.step()
        np.testing.assert_array_equal(t.arena.page_table, j.arena.page_table)
        np.testing.assert_array_equal(t.arena.refcount, j.arena.refcount)
        steps += 1
        assert steps < 600
    key = [(c.req_id, list(map(int, c.tokens)), c.finish_reason,
            c.n_preempts) for c in j.completed[n0:]]
    assert [(c.req_id, list(map(int, c.tokens)), c.finish_reason,
             c.n_preempts) for c in t.completed[n0:]] == key
    return {c.req_id: c for c in t.completed[n0:]}


def _trace_summary():
    path = (pathlib.Path(__file__).resolve().parents[1]
            / "tools" / "trace_summary.py")
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------
# the policy contract
# ---------------------------------------------------------------------
def test_policies_satisfy_protocol():
    assert isinstance(FCFSPolicy(), SchedulingPolicy)
    assert isinstance(PrioritySLOPolicy(), SchedulingPolicy)
    assert isinstance(ScriptedPreemptions({}), SchedulingPolicy)
    assert make_policy("fcfs").name == "fcfs"
    pol = make_policy("priority", preempt=False, slo_ttft_s=2.0)
    assert pol.name == "priority" and not pol.preempt
    assert pol.slo_ttft_s == 2.0
    assert sorted(tpolicy.POLICIES) == sorted(jpolicy.POLICIES)
    with pytest.raises(ValueError):
        make_policy("srpt")


# ---------------------------------------------------------------------
# preemption bit-exactness, lockstep with the reference
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits,prefix_cache", [(8, False), (4, False),
                                                  (8, True), (4, True)])
def test_preempt_resume_token_parity_matches_reference(models, kv_bits,
                                                       prefix_cache):
    """Evictions mid-prefill and mid-decode: every request finishes with
    the tokens of an uninterrupted run, the resume oracle never raises,
    and tables, n_preempts and pools equal the reference's."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(7)
    specs = [(14, 8), (6, 10), (18, 6), (9, 9), (5, 7)]
    prompts = [rng.integers(0, vocab, size=(p,)) for p, _ in specs]
    gens = [g for _, g in specs]
    kw = dict(n_slots=2, kv_bits=kv_bits, prefix_cache=prefix_cache,
              cache_keep_pages=8 if prefix_cache else 0)
    base = _engine(models, True, **kw)
    _submit(base, prompts, gens)
    want = [list(c.tokens) for c in sorted(base.run_until_drained(),
                                           key=lambda c: c.req_id)]
    script = {3: "prefilling", 6: "active", 10: "active", 15: "active"}
    j, t = _pair(models, policy=lambda: ScriptedPreemptions(script), **kw)
    got = _lockstep(j, t, prompts, gens)
    assert [list(got[i].tokens) for i in sorted(got)] == want
    assert t.policy.n_scripted >= 3
    assert t.stats()["n_preempts"] == j.stats()["n_preempts"]
    assert t.stats()["n_preempts"] == t.policy.n_scripted
    assert sum(c.n_preempts for c in got.values()) == t.policy.n_token_bearing
    for kv in ("k", "v"):
        np.testing.assert_array_equal(t.arena.caches[kv].numpy(),
                                      np.asarray(j.arena.caches[0][kv]))


def test_preempt_no_page_leak_matches_reference(models):
    """Repeated preempt / resume rounds on one engine pair hand every
    page back: zero pages in use, zero committed, every slot free, no
    parked resume state, the reference's n_preempts."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(13)
    specs = [(10, 8), (6, 10), (13, 6), (8, 8)]
    prompts = [rng.integers(0, vocab, size=(p,)) for p, _ in specs]
    gens = [g for _, g in specs]
    j, t = _pair(models, n_slots=2, policy=lambda: ScriptedPreemptions(
        {k: "active" for k in range(2, 60, 4)}))
    for _ in range(3):
        _lockstep(j, t, prompts, gens)
        g = t.arena.gauges()
        assert g["pages_in_use"] == 0 and g["committed_pages"] == 0
        assert g["n_free"] == t.arena.n_slots
    assert t.stats()["n_preempts"] == j.stats()["n_preempts"] > 0
    assert not t._resume


# ---------------------------------------------------------------------
# PrioritySLOPolicy planning on hand-built views, against the reference
# ---------------------------------------------------------------------
def _views(pending=(), active=(), prefilling=(), *, free=0, budget=None,
           now=100.0, max_prefills=4, chunk=8, max_chunks=None):
    """The same view twice: built from the reference's snapshot classes
    and from the port's.  pending (req_id, prio, arrival, need, plen);
    active (req_id, slot, prio, admit, pages); prefilling (req_id, slot,
    prio, admit, offset, total, pages)."""
    out = []
    for mod, req_cls in ((jpolicy, JRequest), (tpolicy, Request)):
        pend = []
        for rid, prio, arr, need, plen in pending:
            req = req_cls(np.zeros(plen, np.int32), 4, None, prio)
            req.req_id, req.arrival_time = rid, arr
            pend.append(mod.PendingSnap(
                req=req, req_id=rid, priority=prio, arrival_time=arr,
                prompt_len=plen, max_new_tokens=4, source_len=plen,
                need_pages=need, n_generated=0))
        act = [mod.DecodeSnap(
            req_id=rid, slot=slot, priority=prio, arrival_time=admit,
            admit_time=admit, first_token_time=admit + 0.1, n_generated=2,
            budget_left=2, pages_committed=pages)
            for rid, slot, prio, admit, pages in active]
        pre = [mod.PrefillSnap(
            req_id=rid, slot=slot, priority=prio, arrival_time=admit,
            admit_time=admit, offset=off, total=tot, is_resume=False,
            pages_committed=pages)
            for rid, slot, prio, admit, off, tot, pages in prefilling]
        out.append(mod.EngineView(
            now=now, pending=tuple(pend), prefilling=tuple(pre),
            active=tuple(act), free_slots=free, budget_left=budget,
            gauges={}, prefill_mode="chunked", prefill_chunk=chunk,
            max_chunks_per_step=max_chunks,
            max_prefills_per_step=max_prefills))
    return out


def _summary(plan):
    return (list(plan.preempt), [r.req_id for r in plan.admit],
            list(plan.chunks), plan.decode, list(plan.rejects))


VIEWS = {
    # highest class first, FCFS within a class; the last waits on slots
    "admission_order": (dict(pending=[(0, 0, 1.0, 2, 4), (1, 2, 2.0, 2, 4),
                                      (2, 1, 3.0, 2, 4), (3, 2, 4.0, 2, 4)],
                             free=3), {},
                        ([], [1, 3, 2], [(1, 4), (3, 4), (2, 4)], True,
                         [(0, "no_slot")])),
    # the class-0 newest decode goes, not the class-2 peer
    "eviction_lifo_lowest_class": (
        dict(pending=[(9, 2, 5.0, 2, 4)],
             active=[(0, 0, 0, 1.0, 2), (1, 1, 0, 2.0, 2),
                     (2, 2, 2, 3.0, 2)], free=0, budget=0), {},
        ([1], [9], [(9, 4)], True, [])),
    # an equal class is never evicted
    "eviction_equal_class": (
        dict(pending=[(9, 0, 5.0, 2, 4)], active=[(0, 0, 0, 1.0, 2)],
             free=0, budget=0), {},
        ([], [], [], True, [(9, "no_slot")])),
    # nothing frees enough: the evictions roll back
    "rollback_on_shortfall": (
        dict(pending=[(9, 2, 5.0, 50, 4)], active=[(0, 0, 0, 1.0, 2)],
             free=1, budget=3), {},
        ([], [], [], True, [(9, "no_pages")])),
    # two victims, a prefilling one first (newer), then a decode
    "eviction_takes_several": (
        dict(pending=[(9, 1, 5.0, 5, 4)], active=[(0, 0, 0, 1.0, 2)],
             prefilling=[(1, 1, 0, 3.0, 4, 20, 3), (2, 2, 1, 2.0, 8, 12, 2)],
             free=0, budget=1), {},
        ([1, 0], [9], [(2, 4), (9, 4)], True, [])),
    # an aged request jumps the class order
    "aging_changes_order": (
        dict(pending=[(1, 2, 95.0, 2, 4), (0, 0, 1.0, 2, 4)], free=2),
        dict(slo_ttft_s=10.0),
        ([], [0, 1], [(0, 4), (1, 4)], True, [])),
    # ... but never makes an aged class-0 request evict a class-1 one
    "aging_does_not_evict": (
        dict(pending=[(0, 0, 1.0, 2, 4)], active=[(5, 0, 1, 50.0, 2)],
             free=0, budget=0), dict(slo_ttft_s=10.0),
        ([], [], [], True, [(0, "no_slot")])),
    "no_preempt_flag": (
        dict(pending=[(9, 2, 5.0, 2, 4)], active=[(0, 0, 0, 1.0, 2)],
             free=0, budget=0), dict(preempt=False),
        ([], [], [], True, [(9, "no_slot")])),
    # chunk rows: live prefills by class then admission, capped
    "chunk_packing_capped": (
        dict(pending=[(7, 1, 9.0, 1, 30)],
             prefilling=[(1, 0, 0, 1.0, 0, 20, 3), (2, 1, 2, 2.0, 16, 20, 3)],
             free=1, budget=8, max_chunks=2), {},
        ([], [7], [(2, 4), (1, 8)], True, [])),
}


@pytest.mark.parametrize("case", sorted(VIEWS))
def test_priority_plans_match_reference(case):
    """Each of the port's and the reference's PrioritySLOPolicy plans
    each side's view identically, and as stated."""
    kw_view, kw_pol, want = VIEWS[case]
    j_view, t_view = _views(**kw_view)
    plans = [_summary(cls(**kw_pol).plan(view))
             for cls in (JPrioritySLOPolicy, PrioritySLOPolicy)
             for view in (j_view, t_view)]
    assert plans == [want] * 4


def test_fcfs_plans_match_reference():
    """FCFS: head-of-line admission, FIFO chunks, no preemption; the
    same on both sides' views."""
    j_view, t_view = _views(
        pending=[(4, 2, 1.0, 3, 10), (5, 0, 2.0, 1, 4)],
        prefilling=[(1, 0, 0, 1.0, 8, 20, 3)], free=2, budget=3,
        max_prefills=2)
    plans = [_summary(cls().plan(view)) for cls in (JFCFSPolicy, FCFSPolicy)
             for view in (j_view, t_view)]
    assert plans == [([], [4], [(1, 8), (4, 8)], True,
                      [(5, "no_pages")])] * 4


# ---------------------------------------------------------------------
# organic preemption end to end; the trace
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_priority_end_to_end_overload_matches_reference(models, kv_bits):
    """A class-1 burst lands on a full class-0 arena: every request
    finishes its budget, the victims resume bit-exactly, the schedule
    and n_preempts equal the reference's."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(17)
    lo = [rng.integers(0, vocab, size=(6,)) for _ in range(2)]
    hi = [rng.integers(0, vocab, size=(6,)) for _ in range(2)]
    kw = dict(n_slots=2, max_len=24, kv_bits=kv_bits)
    base = _engine(models, True, **kw)
    _submit(base, lo, [12, 12])
    want = {c.req_id: list(c.tokens) for c in base.run_until_drained()}
    j, t = _pair(models, policy=PrioritySLOPolicy, **kw)
    for eng in (j, t):
        _submit(eng, lo, [12, 12])
        for _ in range(6):
            eng.step()
    np.testing.assert_array_equal(t.arena.page_table, j.arena.page_table)
    done = _lockstep(j, t, hi, [4, 4], prios=[1, 1])
    assert t.stats()["n_preempts"] == j.stats()["n_preempts"] > 0
    for rid, budget in zip(range(4), [12, 12, 4, 4]):
        assert done[rid].finish_reason == "length"
        assert done[rid].n_generated == budget
    for rid in (0, 1):
        assert list(done[rid].tokens) == want[rid]
    g = t.arena.gauges()
    assert g["pages_in_use"] == 0 and g["committed_pages"] == 0


def test_preempt_resume_trace_validates_and_matches_reference(models,
                                                              tmp_path):
    """preempt / resume events pass `tools/trace_summary.py` (the
    lifecycle state machine), resume re-emits nothing, and the trace
    equals the reference's but for the clock."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(29)
    tels = (JTelemetry(), Telemetry())
    j, t = (_engine(models, port, n_slots=2, telemetry=tel,
                    policy=ScriptedPreemptions({4: "active", 8: "active"}))
            for port, tel in zip((False, True), tels))
    specs = [(10, 8), (6, 10), (13, 6), (8, 8)]
    _lockstep(j, t, [rng.integers(0, vocab, size=(p,)) for p, _ in specs],
              [g for _, g in specs])
    n_pre = t.stats()["n_preempts"]
    assert n_pre > 0
    strip = [[{k: v for k, v in e.items() if k != "t"} for e in tel.events]
             for tel in tels]
    assert strip[1] == strip[0]
    kinds = [e["event"] for e in tels[1].events]
    assert kinds.count("preempt") == n_pre
    assert kinds.count("resume") >= 1
    path = tmp_path / "trace.jsonl"
    tels[1].export_trace(str(path))
    ts = _trace_summary()
    events = ts.load_trace(str(path))
    ts.validate(events)
    reqs = ts.lifecycles(events)
    assert sum(r["preempts"] for r in reqs.values()) == n_pre
    assert all(r["finish_reason"] == "length" for r in reqs.values())


# ---------------------------------------------------------------------
# starvation fuzz: the ledger after every step, tokens vs the reference
# ---------------------------------------------------------------------
# (seed, policy, kv_bits, prefix_cache): scripted FCFS evictions,
# PrioritySLO preempting without aging (a schedule that does not depend
# on the clock, so its preemptions are certain), with the reference
# fuzz's 0.05 s aging, and not preempting; int8 and packed pools; the
# prefix cache (shared prompts, warm pages) on half of them
FUZZ = [(0, "scripted", 8, False), (1, "scripted", 4, True),
        (18, "priority", 8, True), (5, "priority", 4, False),
        (8, "priority-aged", 4, True), (4, "priority-no-preempt", 8, True)]


@pytest.fixture(scope="module")
def fuzz_references():
    """One reference engine per (kv_bits, prefix_cache), reused across
    seeds with the seed's policy swapped in (each drains clean)."""
    return {}


def _fuzz_policy(kind, rng):
    if kind == "scripted":
        return ScriptedEvictions(rng.integers(1, 16, size=4))
    return PrioritySLOPolicy(preempt=kind != "priority-no-preempt",
                             slo_ttft_s=None if kind == "priority" else 0.05)


@pytest.mark.parametrize("seed,kind,kv_bits,prefix_cache", FUZZ)
def test_starvation_fuzz_ledger_and_tokens(models, fuzz_references, seed,
                                           kind, kv_bits, prefix_cache):
    """Random prompts, classes, budgets and evictions on a tight pool
    (8 pages for 2 slots), arriving in two waves (the second after a
    random lead of steps, so later classes land on a busy arena): after
    every step the arena's ledger holds (`_assert_ledger`: committed +
    pinned <= n_pages, page and slot conservation, no negative
    refcount); at the end every request has finished once, the arena
    is clean, and every request's tokens equal the reference engine's
    for it.  The cases whose evictions do not hang on the clock do
    evict."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(5, 8))
    pre = rng.integers(0, vocab, size=(8,))
    prompts = []
    for _ in range(n):
        tail = rng.integers(0, vocab, size=(int(rng.integers(2, 12)),))
        prompts.append(np.concatenate([pre, tail]) if prefix_cache
                       and rng.random() < 0.6 else tail)
    gens = [int(rng.integers(1, 8)) for _ in range(n)]
    prios = [int(p) for p in rng.integers(0, 3, size=n)]
    split, lead = int(rng.integers(1, n)), int(rng.integers(1, 6))
    kw = dict(n_slots=2, n_pages=8, kv_bits=kv_bits,
              prefix_cache=prefix_cache,
              cache_keep_pages=4 if prefix_cache else 0)
    key = (kv_bits, prefix_cache)
    if key not in fuzz_references:
        fuzz_references[key] = _engine(models, False, **kw)
    ref = fuzz_references[key]
    n0 = len(ref.completed)
    out = []
    for eng in (_engine(models, True, **kw), ref):
        eng.policy = _fuzz_policy(kind, np.random.default_rng(seed))
        ids = _submit(eng, prompts[:split], gens[:split], prios[:split])
        steps = 0
        while True:
            if steps == lead:
                ids += _submit(eng, prompts[split:], gens[split:],
                               prios[split:])
            if not eng.step() and steps >= lead:
                break
            steps += 1
            if eng is not ref:
                _assert_ledger(eng)
            assert steps < 600, "drain exceeded the step bound"
        done = {c.req_id: list(c.tokens) for c in eng.completed[
            n0 if eng is ref else 0:]}
        assert sorted(done) == sorted(ids)
        out.append([done[i] for i in ids])
        if eng is not ref:
            port = eng
    assert out[0] == out[1]
    assert not port.active and not port.prefilling and not port._resume
    assert port.arena.committed_pages == 0
    assert int((port.arena.refcount != 0).sum()) == 0
    assert port.arena.n_free == port.arena.n_slots
    if kind in ("scripted", "priority"):
        assert port.stats()["n_preempts"] > 0
    if kind == "priority-no-preempt":
        assert port.stats()["n_preempts"] == 0
    if prefix_cache:
        ref.arena.flush_cache()
