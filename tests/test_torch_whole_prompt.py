"""The reference's default arena and whole-prompt serving in the port,
against the JAX reference's, at tolerance 0.

`ServingConfig()` serves over `SlotArena` (the reference's default,
`paged=False`), and `prefill_chunk` 0 prefills each prompt whole at
batch 1, padded to a `prefill_bucket` multiple ("bucketed").  Both
engines get the same deployed tables (reduced granite_3_2b), the same
requests and the same submit / step sequence; held here:

  - the slot arena's host state (leases, free list, lengths, gauges)
    after every step, and its caches after the drain (the port's slot
    pages against the reference's (B, K, T, hd) rows);
  - the engine over `SlotArena` in chunked and bucketed mode, at
    dispatch depth 0 and 1: tokens, finish reasons, steps, `stats()`,
    the trace and the step records (but the clock);
  - bucketed mode over the paged arena (the reference's gather path),
    tokens and page tables after every step;
  - `serve_batch` against the reference's, and the port's engine
    against `serve_batch` for simultaneous same-length requests, as
    `tests/test_serving.py` holds the reference's;
  - the configuration checks (paged default, kv_bits 4 and the prefix
    cache need the paged arena and the chunked mode), `bucket_len` and
    the CLI (the blockwise width above 4096 rows is held in
    `tests/test_torch_blockwise.py`).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import (
    deploy_model as j_deploy_model, serve_batch as j_serve_batch,
)
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine, Telemetry as JTelemetry,
)
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import main as serve_main, serve_batch
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    SchedulerConfig, Scheduler, ServingConfig, ServingEngine, SlotArena,
    Telemetry,
)

MAX_LEN = 40
N_SLOTS = 3
BUCKET = 8
# (prompt length, new tokens): inside a bucket, on and across bucket
# edges, a 1-token prompt, one near the arena's end
SPECS = [(8, 6), (3, 4), (12, 5), (1, 3), (8, 4), (5, 6), (17, 3), (33, 6)]
# the stats() keys read off the clock
TIMED = {"wall_s", "throughput_tok_s"}


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _engine(models, port: bool, *, chunk, depth=0, telemetry=None,
            paged=False, n_slots=N_SLOTS, max_len=MAX_LEN, config=None,
            **sched):
    """An engine of each side; `config` adds ServingConfig fields,
    `sched` SchedulerConfig ones."""
    jlm, jt, tlm, tt = models
    sched = dict(prefill_chunk=chunk, prefill_bucket=BUCKET, **sched)
    kw = dict(n_slots=n_slots, max_len=max_len, dispatch_depth=depth,
              telemetry=telemetry, **(config or {}))
    if paged:
        kw.update(paged=True, page_size=8)
    if port:
        return ServingEngine(tlm, tt, ServingConfig(
            device="cpu", scheduler=SchedulerConfig(**sched), **kw))
    if paged:
        kw["paged_kernel"] = False
    return JServingEngine(jlm, jt, JServingConfig(
        scheduler=JSchedulerConfig(**sched), **kw))


def _workload(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(p,)), g) for p, g in SPECS]


def _busy(eng):
    return bool(eng.sched.n_pending or eng.prefilling or eng.active
                or eng.queue.pending)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _arena_state(a):
    state = {"owner": list(a.owner), "lengths": a.lengths.tolist(),
             "n_free": a.n_free, "n_leased": a.n_leased,
             "gauges": _plain(a.gauges())}
    if hasattr(a, "page_table"):
        state["page_table"] = a.page_table.tolist()
    else:
        state["free"] = list(a._free)
    return state


def _lockstep(j, t, workload):
    """Submit one request and step, then drain, both engines together;
    the arenas' host state equal after every step.  -> (reference,
    port) completions as (req_id, tokens, finish reason)."""
    steps = 0
    for prompt, g in workload:
        for eng in (j, t):
            eng.submit(copy.deepcopy(prompt), max_new_tokens=g)
        assert j.step() == t.step()
        assert _arena_state(t.arena) == _arena_state(j.arena)
    while _busy(j) or _busy(t):
        assert j.step() == t.step()
        assert _arena_state(t.arena) == _arena_state(j.arena)
        steps += 1
        assert steps < 300
    return [[(c.req_id, list(map(int, c.tokens)), c.finish_reason)
             for c in eng.completed] for eng in (j, t)]


def _slot_pools_equal(j, t):
    """The port's slot pages 1..n against the reference's cache rows,
    every layer, byte for byte."""
    ref = j.arena.caches[0]
    for kv in ("k", "v"):
        want = np.asarray(ref[kv])                 # (L, B, K, T, hd)
        got = t.arena.caches[kv][:, 1:].numpy()    # (L, B, K, T, hd)
        np.testing.assert_array_equal(got, want, err_msg=kv)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("chunk", [8, 0])
def test_slot_arena_engine_equals_reference(models, chunk, depth):
    """Chunked (8) and bucketed (0) over SlotArena at depth 0 and 1:
    arena state after every step, tokens, stats(), trace and step
    records equal but the clock, and the caches after the drain."""
    jtel, ttel = JTelemetry(), Telemetry()
    j = _engine(models, False, chunk=chunk, depth=depth, telemetry=jtel)
    t = _engine(models, True, chunk=chunk, depth=depth, telemetry=ttel)
    assert isinstance(t.arena, SlotArena)
    assert t._prefill_mode == j._prefill_mode == (
        "chunked" if chunk else "bucketed")
    ref, got = _lockstep(j, t, _workload(models[2].cfg.vocab))
    assert got == ref
    assert [len(toks) for _, toks, _ in sorted(got)] == [
        g for _, g in SPECS]
    js, ts = _plain(j.stats()), _plain(t.stats())
    assert ts["arena"] == "slot"
    for k, v in js.items():
        if k not in TIMED and not k.endswith("_s"):
            assert ts[k] == v, k

    def no_t(evs):
        return [{k: v for k, v in _plain(e).items() if k != "t"}
                for e in evs]

    assert no_t(ttel.events) == no_t(jtel.events)
    timed = {"t", "wall_s", "phases"}
    assert len(ttel.steps) == len(jtel.steps)
    for p, r in zip(ttel.steps, jtel.steps):
        assert {k: _plain(v) for k, v in p.items() if k not in timed} == {
            k: _plain(v) for k, v in r.items() if k not in timed}
        assert p["phases"].keys() == r["phases"].keys()
    _slot_pools_equal(j, t)


@pytest.mark.parametrize("depth", [0, 1])
def test_bucketed_over_the_paged_arena_equals_reference(models, depth):
    """prefill_chunk 0 over the paged arena (the one-shot prefill
    scattered through the page table row): page tables after every
    step and tokens equal to the reference's gather path."""
    j = _engine(models, False, chunk=0, depth=depth, paged=True)
    t = _engine(models, True, chunk=0, depth=depth, paged=True)
    ref, got = _lockstep(j, t, _workload(models[2].cfg.vocab, seed=1))
    assert got == ref
    assert t.stats()["steps"] == j.stats()["steps"]


def test_warmup_leaves_the_slot_pools_byte_equal(models):
    """warmup runs the bucketed mode's decode with every row parked:
    only the trash page takes its writes."""
    t = _engine(models, True, chunk=0)
    for kv in ("k", "v"):
        t.arena.caches[kv][:, 1:] = torch.randint(
            -128, 128, t.arena.caches[kv][:, 1:].shape, dtype=torch.int8,
            generator=torch.Generator().manual_seed(3))
    before = {kv: t.arena.caches[kv][:, 1:].clone() for kv in ("k", "v")}
    t.warmup()
    for kv in ("k", "v"):
        assert torch.equal(t.arena.caches[kv][:, 1:], before[kv])


@pytest.mark.parametrize("P", [8, 6])
def test_serve_batch_equals_reference_and_the_engine(models, P):
    """The lockstep oracle against the reference's; then simultaneous
    same-length requests through the port's engine (chunked and
    bucketed; P 6 pads to the 8-bucket) give its tokens."""
    jlm, jt, tlm, tt = models
    G, B = 6, 4
    prompts = np.random.default_rng(P).integers(
        0, tlm.cfg.vocab, size=(B, P)).astype(np.int32)
    want = np.asarray(j_serve_batch(jlm, jt, jnp.asarray(prompts), G))
    got = serve_batch(tlm, tt, prompts, G)
    assert got.dtype == torch.int32 and got.shape == (B, G)
    np.testing.assert_array_equal(got.numpy(), want)
    for chunk in (32, 0):
        eng = _engine(models, True, chunk=chunk, n_slots=B, max_len=P + G,
                      max_prefills_per_step=B)
        ids = [eng.submit(prompts[i], max_new_tokens=G) for i in range(B)]
        done = {c.req_id: c.tokens for c in eng.run_until_drained()}
        for i, rid in enumerate(ids):
            assert done[rid] == list(want[i]), (chunk, i)


def test_slot_arena_leases_as_the_reference(models):
    """Leases from the lowest free slot, recycled LIFO; write_slot copies
    a B=1 cache into the slot's page and nothing else."""
    from repro.serving.cache import SlotArena as JSlotArena

    jlm, _, tlm, _ = models
    j = JSlotArena(jlm, 4, MAX_LEN)
    t = SlotArena(tlm, 4, MAX_LEN, device="cpu")
    for op in [("alloc", 0, 5), ("alloc", 1, 9), ("alloc", 2, 1),
               ("release", 1), ("alloc", 3, 7), ("release", 0),
               ("alloc", 4, 2), ("advance", 2)]:
        if op[0] == "alloc":
            assert t.alloc(op[1], op[2]) == j.alloc(op[1], op[2])
        elif op[0] == "release":
            t.release(op[1])
            j.release(op[1])
        else:
            t.advance(op[1], 3)
            j.advance(op[1], 3)
        assert _arena_state(t) == _arena_state(j)
        assert t.stats() == j.stats()
        assert t.reject_reason(1, 2) == j.reject_reason(1, 2)
    with pytest.raises(RuntimeError):
        t.release(3)  # never leased
    single = tlm.init_caches(1, MAX_LEN, device="cpu")
    single["k"][:, 1] = 7
    t.write_slot(2, single)
    k = t.caches["k"]
    assert bool((k[:, 3] == 7).all()) and not bool((k[:, 2] == 7).any())
    assert t.decode_view()["table"].tolist() == [[1], [2], [3], [4]]


def test_config_checks_and_buckets_equal_reference():
    assert ServingConfig().paged is False and JServingConfig().paged is False
    for kw, match in ((dict(kv_bits=4), "kv_bits=4 needs the paged arena"),
                      (dict(prefix_cache=True), "prefix_cache=True needs")):
        with pytest.raises(ValueError, match=match):
            ServingConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JServingConfig(**kw)
        assert ServingConfig(paged=True, **kw).paged
    for cfg in (SchedulerConfig(prefill_bucket=0),
                SchedulerConfig(prefill_chunk=-1)):
        with pytest.raises(ValueError):
            Scheduler(cfg, 64)
    t = Scheduler(SchedulerConfig(prefill_chunk=0, prefill_bucket=8), 40)
    j = JScheduler(JSchedulerConfig(prefill_chunk=0, prefill_bucket=8), 40)
    assert [t.bucket_len(n) for n in range(1, 41)] == [
        j.bucket_len(n) for n in range(1, 41)]
    assert SchedulerConfig().prefill_bucket == JSchedulerConfig(
        ).prefill_bucket


def test_whole_prompt_modes_refuse_kv4_and_the_prefix_cache(models):
    for kw, what in ((dict(kv_bits=4), "kv_bits=4"),
                     (dict(prefix_cache=True), "prefix_cache=True")):
        for port in (True, False):
            with pytest.raises(ValueError,
                               match=f"{what} requires the chunked"):
                _engine(models, port, chunk=0, paged=True, config=kw)


def test_cli_serves_the_reference_default_arena(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--gen", "3",
                "--max-len", "16", "--ragged", "--prefill-chunk", "0",
                "--prefill-bucket", "8"])
    out = capsys.readouterr().out
    assert "drained 3 requests / 9 tokens" in out
    assert "slot arena of 32 positions" in out


@pytest.mark.parametrize("B,S", [(8, 1), (1, 31), (1, 254), (1, 512)])
def test_paged_plan_fits_the_slot_pools(B, S):
    """The slot arena's pools read as pages of max_len 512 keys, one a
    slot (pps 1): olmoe's heads (16 kv heads, group 1, hd 128) at decode
    and at B=1 whole-prompt prefills up to 512 rows take a launch that
    fits shared memory; granite's (8 kv heads, group 4, hd 64) too."""
    from repro_torch.kernels.paged_attention import _SMEM_LIMIT, paged_plan

    for K, group, hd in ((16, 1, 128), (8, 4, 64)):
        p = paged_plan(B, K, group, S, hd, 512, 1)
        assert p.smem <= _SMEM_LIMIT, (K, group, hd, p)
        assert p.blocks == B * K * -(-(group * S) // p.rows)
        assert p.keys * p.stages <= 4 * 256
