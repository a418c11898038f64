"""The port's prefix cache against the JAX reference's, at tolerance 0.

The reference runs `ServingEngine(paged=True, paged_kernel=False,
prefix_cache=True)` (its paged arena through the write-then-gather
attention path, which runs under this jax); the port runs its engine on
the CPU.  Both get the same deployed tables (reduced granite_3_2b), the
same requests and the same submit / step sequence, stepped in lockstep:
after every step the page tables, refcounts, lengths, free lists and
warm lists must agree; after the drain the tokens, every prefix counter
of `stats()` and both pools (byte for byte) must.  The workloads are
`tests/test_prefix_cache.py`'s: shared prefixes diverging at a page
boundary and mid-page with an aligned-exact twin (one copy-on-write),
random mixes under scripted preemptions, the suffix-only admission
ledger, warm pages revived by a match, a resume that re-prefills at
most one chunk, and the trace events.  The sharded case is left out
(the port has no multi-device serving).
"""
import copy
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    PagedArena as JPagedArena, SchedulerConfig as JSchedulerConfig,
    ServingConfig as JServingConfig, ServingEngine as JServingEngine,
    Telemetry as JTelemetry,
)
from repro_torch.configs.base import get_config
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    PagedArena, SchedulerConfig, ServingConfig, ServingEngine, Telemetry,
)
from test_policy import ScriptedPreemptions


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
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_pages",
               "cow_splits", "warm_evictions", "cache_pages", "warm_pages",
               "n_preempts", "steps", "admit_rejects", "max_pages_in_use",
               "max_committed_pages", "committed_pages", "pages_in_use")


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _pair(models, *, chunk=PS, policy=None, telemetry=None, **kw):
    """A reference and a port engine of one configuration; `policy` is
    a factory (stateful policies are built once per engine),
    `telemetry` a pair of sinks."""
    jlm, jt, tlm, tt = models
    tel = telemetry or (None, None)
    j = JServingEngine(jlm, jt, JServingConfig(
        max_len=MAX_LEN, paged=True, page_size=PS, paged_kernel=False,
        policy=policy() if policy else None, telemetry=tel[0],
        scheduler=JSchedulerConfig(prefill_chunk=chunk), **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        max_len=MAX_LEN, paged=True, page_size=PS, device="cpu",
        policy=policy() if policy else None, telemetry=tel[1],
        scheduler=SchedulerConfig(prefill_chunk=chunk), **kw))
    return j, t


def _port(models, *, chunk=PS, **kw):
    """A port engine alone (the cache-off runs whose tokens the cache-on
    runs must equal)."""
    return ServingEngine(models[2], models[3], ServingConfig(
        max_len=MAX_LEN, paged=True, page_size=PS, device="cpu",
        scheduler=SchedulerConfig(prefill_chunk=chunk), **kw))


def _serve(eng, prompts, gens):
    for p, g in zip(prompts, gens):
        eng.submit(np.asarray(p), max_new_tokens=g)
    return {c.req_id: list(map(int, c.tokens))
            for c in eng.run_until_drained()}


def _busy(eng):
    return bool(eng.sched.n_pending or eng.prefilling or eng.active)


def _assert_arenas_equal(ja, ta):
    np.testing.assert_array_equal(ta.page_table, ja.page_table)
    np.testing.assert_array_equal(ta.refcount, ja.refcount)
    np.testing.assert_array_equal(ta.lengths, ja.lengths)
    assert ta._free_pages == ja._free_pages
    assert list(ta._warm) == list(ja._warm)
    assert sorted(ta._page_node) == sorted(ja._page_node)
    assert ta.committed_pages == ja.committed_pages
    assert ta.budget_left == ja.budget_left


def _assert_pools_equal(j, t):
    for kv in ("k", "v"):
        np.testing.assert_array_equal(t.arena.caches[kv].numpy(),
                                      np.asarray(j.arena.caches[0][kv]))


def _lockstep(j, t, prompts, gens, prios=None):
    """Submit the same requests to both engines and step them together,
    holding their arenas equal after every step; -> the port's tokens by
    req_id of this call's requests (equal to the reference's)."""
    prios = prios or [0] * len(prompts)
    n0 = len(t.completed)
    assert len(j.completed) == n0
    for eng in (j, t):
        for p, g, pr in zip(prompts, gens, prios):
            eng.submit(np.asarray(p), max_new_tokens=g, priority=pr)
    steps = 0
    while _busy(j) or _busy(t):
        assert j.step() == t.step()
        _assert_arenas_equal(j.arena, t.arena)
        steps += 1
        assert steps < 500
    jc, tc = j.completed[n0:], t.completed[n0:]
    tt = {c.req_id: list(map(int, c.tokens)) for c in tc}
    assert tt == {c.req_id: list(map(int, c.tokens)) for c in jc}
    assert [c.req_id for c in tc] == [c.req_id for c in jc]
    assert [c.n_preempts for c in tc] == [c.n_preempts for c in jc]
    return tt


def _assert_stats_equal(j, t):
    js, ts = j.stats(), t.stats()
    for k in PREFIX_KEYS:
        if k in js or k in ts:
            assert ts[k] == js[k], k


def _assert_drained_clean(arena):
    assert int((arena.refcount != 0).sum()) == 0
    assert arena.committed_pages == 0
    assert arena.pages_in_use == arena.warm_pages
    assert arena.warm_pages <= arena.keep_pages


def _trace_summary():
    path = (pathlib.Path(__file__).resolve().parents[1]
            / "tools" / "trace_summary.py")
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _untimed(events):
    """Trace events without their clock stamps, numpy scalars as Python
    ones."""
    out = []
    for e in events:
        out.append({k: (v.item() if isinstance(v, np.generic) else v)
                    for k, v in e.items() if k != "t"})
    return out


def _twin_workload(vocab, diverge, seed=3):
    """Three requests sharing a prefix (diverging at a page boundary or
    mid-page) and an aligned-exact twin of its first two pages."""
    rng = np.random.default_rng(seed)
    cut = 16 if diverge == "boundary" else 20
    pre = rng.integers(0, vocab, size=(cut,))
    prompts = [np.concatenate([pre, rng.integers(0, vocab, size=(5,))])
               for _ in range(3)]
    prompts.append(np.asarray(pre[:16]).copy())
    return prompts, [6, 6, 6, 6]


# ---------------------------------------------------------------------
# exactness: shared-prefix == cold == the reference, lockstep
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("diverge", ["boundary", "midpage"])
def test_shared_prefix_parity_matches_reference(models, diverge, kv_bits):
    """Cache-on tokens equal cache-off tokens and the reference's; the
    twin is a hit on both pages and splits the one it writes; tables,
    refcounts, counters and both pools equal the reference's."""
    prompts, gens = _twin_workload(models[2].cfg.vocab, diverge)
    kw = dict(n_slots=2, kv_bits=kv_bits)
    cold = _serve(_port(models, **kw), prompts, gens)
    j, t = _pair(models, prefix_cache=True, cache_keep_pages=12, **kw)
    shared = _lockstep(j, t, prompts, gens)
    assert shared == cold
    _assert_stats_equal(j, t)
    st = t.stats()
    assert st["prefix_hits"] >= 1
    assert st["prefix_hit_pages"] >= 2
    assert st["cow_splits"] >= 1
    _assert_drained_clean(t.arena)
    _assert_pools_equal(j, t)


@pytest.mark.parametrize("kv_bits,keep", [(8, 10), (4, 10), (8, 2)])
def test_refcount_leak_freedom_random_matches_reference(models, kv_bits,
                                                        keep):
    """Random rounds of shared-prefix and cold prompts under scripted
    preemptions, cache on and off, lockstep with the reference: equal
    tokens across on/off, equal counters (keep 2 forces warm
    evictions), clean drains, and flush_cache empties the pool."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(5)
    pre = rng.integers(0, vocab, size=(16,))
    # one engine pair per mode, reused round after round (each drains
    # clean, and the cache-on pair is flushed to pristine)
    pairs = {on: _pair(models, n_slots=2, kv_bits=kv_bits, chunk=4,
                       prefix_cache=on, cache_keep_pages=keep if on else 0)
             for on in (False, True)}
    evictions = 0
    for _ in range(3):
        n = int(rng.integers(3, 6))
        prompts, gens = [], []
        for _ in range(n):
            if rng.random() < 0.6:
                sfx = rng.integers(0, vocab, size=(int(rng.integers(1, 8)),))
                prompts.append(np.concatenate([pre, sfx]))
            else:
                prompts.append(rng.integers(
                    0, vocab, size=(int(rng.integers(5, 20)),)))
            gens.append(
                min(int(rng.integers(4, 10)), MAX_LEN - len(prompts[-1])))
        script = {int(i): "active" for i in rng.integers(2, 25, size=3)}
        outs = {}
        for on in (False, True):
            j, t = pairs[on]
            for eng in (j, t):
                eng.policy = ScriptedPreemptions(script)
            outs[on] = _lockstep(j, t, prompts, gens)
            _assert_stats_equal(j, t)
            _assert_pools_equal(j, t)
            if on:
                evictions = t.stats()["warm_evictions"]
                _assert_drained_clean(t.arena)
                assert t.arena.flush_cache() == j.arena.flush_cache()
                assert t.arena.warm_pages == 0
                assert t.arena.pages_in_use == 0
                assert t.arena.free_pages == t.arena.n_pages
        assert outs[True] == outs[False]
        assert len(outs[True]) == n
    if keep == 2:
        assert evictions > 0


# ---------------------------------------------------------------------
# arena-level ledger arithmetic, side by side with the reference arena
# ---------------------------------------------------------------------
def _arenas(models, **kw):
    jlm, _, tlm, _ = models
    return (JPagedArena(jlm, max_len=MAX_LEN, page_size=PS, **kw),
            PagedArena(tlm, max_len=MAX_LEN, page_size=PS, device="cpu",
                       **kw))


def _both(arenas, fn):
    """Apply `fn` to both arenas; their results must agree."""
    a, b = (fn(x) for x in arenas)
    assert b == a
    _assert_arenas_equal(*arenas)
    return b


def test_suffix_only_admission_ledger_matches_reference(models):
    """Registration moves pages from the slot's commit to the cache
    ledger, admit_cost discounts exactly the matched pages, a sharing
    request admits where a cold one cannot, and the donor's release
    leaves the shared pages warm: every quantity equal to the
    reference arena's."""
    arenas = _arenas(models, n_slots=3, n_pages=7, prefix_cache=True,
                     keep_pages=7)
    toks = np.random.default_rng(11).integers(
        0, models[2].cfg.vocab, size=(24,)).astype(np.int32)
    total = 30
    assert _both(arenas, lambda a: a.pages_needed(total)) == 4
    assert _both(arenas, lambda a: a.admit_cost(total, tokens=toks)) == 4
    slot = _both(arenas, lambda a: a.alloc(0, 24, total, written=0,
                                           tokens=toks))
    _both(arenas, lambda a: a.touch_range(slot, 0, 16))
    _both(arenas, lambda a: a.advance(slot, 16))
    _both(arenas, lambda a: a.register_prefix(slot, toks, 16))
    got = _both(arenas, lambda a: (a.cache_pages, a.committed_pages,
                                   a.pinned_cache_pages))
    assert got == (2, 2, 2)
    assert _both(arenas, lambda a: a.admit_cost(total, tokens=toks)) == 2
    assert _both(arenas, lambda a: a.can_admit(24, total, tokens=toks))
    assert not _both(arenas, lambda a: a.can_admit(24, total))
    _both(arenas, lambda a: a.release(slot))
    got = _both(arenas, lambda a: (a.committed_pages, a.warm_pages,
                                   a.pinned_cache_pages))
    assert got == (0, 2, 0)
    assert int((arenas[1].refcount != 0).sum()) == 0


def test_can_admit_counts_revived_warm_pages_matches_reference(models):
    """Warm pages a request matches stop being evictable once installed,
    so can_admit charges them: a sharing request is refused where a
    cold one of the same size admits, in both arenas."""
    arenas = _arenas(models, n_slots=3, n_pages=4, prefix_cache=True,
                     keep_pages=4)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, models[2].cfg.vocab, size=(17,)).astype(np.int32)
    s = _both(arenas, lambda a: a.alloc(0, 17, 18, written=0, tokens=toks))
    _both(arenas, lambda a: a.touch_range(s, 0, 16))
    _both(arenas, lambda a: a.advance(s, 16))
    _both(arenas, lambda a: a.register_prefix(s, toks, 16))
    _both(arenas, lambda a: a.release(s))
    assert _both(arenas, lambda a: (a.warm_pages, a.free_pages)) == (2, 2)
    _both(arenas, lambda a: a.alloc(1, 11, 12, written=0))
    assert _both(arenas, lambda a: a.committed_pages) == 2
    shared = np.concatenate(
        [toks[:16], rng.integers(0, models[2].cfg.vocab, size=(1,))]
    ).astype(np.int32)
    assert _both(arenas, lambda a: a.admit_cost(18, tokens=shared)) == 1
    assert not _both(arenas, lambda a: a.can_admit(17, 18, tokens=shared))
    assert _both(arenas, lambda a: a.can_admit(11, 12))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cow_copies_one_page_and_leaves_the_rest(models, kv_bits):
    """A write into a registered page splits it: the new page's bytes
    equal the old page's on both pools (int4-packed at kv_bits 4), every
    other page is untouched, and the table, refcounts and counters equal
    the reference arena's after the same split."""
    arenas = _arenas(models, n_slots=2, n_pages=6, prefix_cache=True,
                     keep_pages=6, kv_bits=kv_bits)
    rng = np.random.default_rng(17)
    shape = tuple(arenas[1].caches["k"].shape)
    init = {kv: rng.integers(-128, 128, size=shape).astype(np.int8)
            for kv in ("k", "v")}
    ja, ta = arenas
    ja.caches = [{kv: jax.numpy.asarray(init[kv]) for kv in ("k", "v")}]
    for kv in ("k", "v"):
        ta.caches[kv].copy_(torch.from_numpy(init[kv]))
    toks = rng.integers(0, models[2].cfg.vocab, size=(16,)).astype(np.int32)
    s0 = _both(arenas, lambda a: a.alloc(0, 16, 20, written=0, tokens=toks))
    _both(arenas, lambda a: a.touch_range(s0, 0, 16))
    _both(arenas, lambda a: a.advance(s0, 16))
    _both(arenas, lambda a: a.register_prefix(s0, toks, 16))
    s1 = _both(arenas, lambda a: a.alloc(1, 16, 20, written=0, tokens=toks))
    assert _both(arenas, lambda a: int(a.lengths[s1])) == 15
    old = int(ta.page_table[s1, 1])
    _both(arenas, lambda a: a.touch(s1, 15))  # the twin's tail: a split
    new = int(ta.page_table[s1, 1])
    assert new != old and _both(arenas, lambda a: a.cow_splits) == 1
    for kv in ("k", "v"):
        got = ta.caches[kv].numpy()
        want = init[kv].copy()
        want[:, new] = want[:, old]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(ja.caches[0][kv]))


# ---------------------------------------------------------------------
# preemption resume rides the cache; the trace events
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_resume_refills_at_most_one_chunk_matches_reference(models,
                                                            kv_bits):
    """A preempted request whose pages stayed warm re-prefills at most
    one chunk, its resume is a prefix hit, its tokens equal an
    uninterrupted run's, and the port's trace equals the reference's
    but for the clock."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, vocab, size=(18,)),
               rng.integers(0, vocab, size=(10,))]
    gens = [10, 8]
    cold = _serve(_port(models, n_slots=2, kv_bits=kv_bits), prompts, gens)
    tels = (JTelemetry(), Telemetry())
    j, t = _pair(models, n_slots=2, kv_bits=kv_bits, prefix_cache=True,
                 cache_keep_pages=16, telemetry=tels,
                 policy=lambda: ScriptedPreemptions({6: "active"}))
    assert _lockstep(j, t, prompts, gens) == cold
    assert t.policy.n_token_bearing >= 1
    _assert_stats_equal(j, t)
    _assert_pools_equal(j, t)
    events = tels[1].events
    assert _untimed(events) == _untimed(tels[0].events)
    preempts = [e for e in events if e["event"] == "preempt"]
    assert preempts
    rid, t0 = preempts[0]["req_id"], preempts[0]["t"]
    refill = [e for e in events if e["event"] == "prefill_chunk"
              and e["req_id"] == rid and e["t"] > t0]
    assert len(refill) <= 1
    assert any(e["event"] == "prefix_hit" and e["req_id"] == rid
               and e["t"] > t0 and e["pages"] >= 1 for e in events)
    assert any(e["event"] == "resume" and e["req_id"] == rid for e in events)
    _assert_drained_clean(t.arena)


def test_prefix_trace_validates_and_matches_reference(models, tmp_path):
    """prefix_hit / prefix_miss / cow_split events pass
    `tools/trace_summary.py`, roll up the shared pages and the split,
    and equal the reference's trace but for the clock."""
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(21)
    pre = rng.integers(0, vocab, size=(16,))
    prompts = [np.concatenate([pre, rng.integers(0, vocab, size=(3,))]),
               np.asarray(pre).copy(),
               np.concatenate([pre, rng.integers(0, vocab, size=(5,))])]
    tels = (JTelemetry(), Telemetry())
    j, t = _pair(models, n_slots=1, telemetry=tels, prefix_cache=True,
                 cache_keep_pages=12)
    _lockstep(j, t, prompts, [5, 5, 5])
    assert _untimed(tels[1].events) == _untimed(tels[0].events)
    kinds = {e["event"] for e in tels[1].events}
    assert {"prefix_hit", "prefix_miss", "cow_split"} <= kinds
    path = tmp_path / "trace.jsonl"
    tels[1].export_trace(str(path))
    ts = _trace_summary()
    events = ts.load_trace(str(path))
    ts.validate(events)
    reqs = ts.lifecycles(events)
    assert len(reqs) == 3
    assert sum(r["prefix_pages"] for r in reqs.values()) >= 2
    assert sum(r["cow_splits"] for r in reqs.values()) >= 1
    out = ts.summarize(events, reqs)
    assert "prefix cache:" in out and "cow splits" in out


def test_warm_pages_survive_reset_stats_and_warmup(models):
    """reset_stats zeroes the prefix counters but keeps the warm pages,
    warmup leaves them byte-equal, and the next window's twin is a hit
    on them: the same as the reference engine."""
    prompts, gens = _twin_workload(models[2].cfg.vocab, "boundary", seed=4)
    j, t = _pair(models, n_slots=2, prefix_cache=True, cache_keep_pages=12)
    _lockstep(j, t, prompts[:1], gens[:1])
    for eng in (j, t):
        eng.reset_stats()
    assert t.stats()["prefix_hits"] == 0 and t.arena.warm_pages > 0
    before = [t.arena.caches[kv][:, 1:].clone() for kv in ("k", "v")]
    for eng in (j, t):
        eng.warmup()
    for kv, b in zip(("k", "v"), before):
        assert torch.equal(t.arena.caches[kv][:, 1:], b)
    _lockstep(j, t, copy.deepcopy(prompts[3:]), gens[3:])
    _assert_stats_equal(j, t)
    assert t.stats()["prefix_hit_pages"] == 2
    _assert_pools_equal(j, t)


# ---------------------------------------------------------------------
# config surface
# ---------------------------------------------------------------------
def test_prefix_cache_config_validation():
    """cache_keep_pages needs the cache and must be >= 0, as in the
    reference; the port has no unpaged arena, so prefix_cache alone is
    valid."""
    with pytest.raises(ValueError, match="cache_keep_pages"):
        ServingConfig(cache_keep_pages=4)
    with pytest.raises(ValueError, match="cache_keep_pages"):
        ServingConfig(paged=True, prefix_cache=True, cache_keep_pages=-1)
    with pytest.raises(ValueError):
        JServingConfig(cache_keep_pages=4)
    cfg = ServingConfig(paged=True, prefix_cache=True, cache_keep_pages=3)
    assert cfg.prefix_cache and cfg.cache_keep_pages == 3
    assert not ServingConfig().prefix_cache
