"""The port's ServingEngine against the JAX reference's, token for token.

The reference runs `ServingEngine(paged=True, paged_kernel=False)` —
its paged arena with chunked prefill through the write-then-gather
attention path, which runs under this jax.  The port runs its engine
on the CPU (kernel wrappers take their plain versions).  Both get the
same deployed tables, the same requests and the same submit/step
sequence, so the FCFS schedule — admissions, chunk rows, page
allocations, backpressure — and every greedy token must agree.
"""
import jax
import numpy as np
import pytest

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine,
)

MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _drive(engine, prompts, gens, stagger):
    """Submit the first `stagger` requests, step twice, submit the rest
    (arrivals interleaved with decoding), drain."""
    for p, g in zip(prompts[:stagger], gens[:stagger]):
        engine.submit(p, g)
    engine.step()
    engine.step()
    for p, g in zip(prompts[stagger:], gens[stagger:]):
        engine.submit(p, g)
    done = engine.run_until_drained()
    return {c.req_id: list(c.tokens) for c in done}, [c.req_id for c in done]


def _run_both(models, prompts, gens, *, n_slots, page_size, n_pages, chunk,
              stagger=3):
    jlm, jt, tlm, tt = models
    j_eng = JServingEngine(jlm, jt, JServingConfig(
        n_slots=n_slots, max_len=MAX_LEN, paged=True, page_size=page_size,
        n_pages=n_pages, paged_kernel=False,
        scheduler=JSchedulerConfig(prefill_chunk=chunk)))
    t_eng = ServingEngine(tlm, tt, ServingConfig(
        n_slots=n_slots, max_len=MAX_LEN, page_size=page_size,
        n_pages=n_pages, device="cpu",
        scheduler=SchedulerConfig(prefill_chunk=chunk)))
    j_tok, j_order = _drive(j_eng, prompts, gens, stagger)
    t_tok, t_order = _drive(t_eng, prompts, gens, stagger)
    assert len(t_tok) == len(prompts)
    assert t_tok == j_tok
    assert t_order == j_order  # same completion order: same schedule
    for rid, g in enumerate(gens):
        assert len(t_tok[rid]) == g
    return j_eng.stats(), t_eng.stats()


def test_ragged_workload_matches_reference(models):
    rng = np.random.default_rng(1)
    lens = [5, 17, 33, 40, 1, 16, 32, 12]
    gens = [6, 4, 8, 3, 5, 7, 2, 6]
    prompts = [rng.integers(0, 256, size=(n,)) for n in lens]
    js, ts = _run_both(models, prompts, gens, n_slots=4, page_size=8,
                       n_pages=24, chunk=16)
    assert ts["steps"] == js["steps"]
    assert ts["max_pages_in_use"] == js["max_pages_in_use"]


def test_prompts_on_page_and_chunk_boundaries_match(models):
    """page_size 8, chunk 12: prompts ending exactly on a page (8, 16,
    24), on a chunk (12, 24, 36) and one past each."""
    rng = np.random.default_rng(2)
    lens = [8, 16, 24, 12, 36, 9, 13, 25]
    gens = [4, 5, 3, 6, 2, 5, 4, 3]
    prompts = [rng.integers(0, 256, size=(n,)) for n in lens]
    _run_both(models, prompts, gens, n_slots=3, page_size=8, n_pages=18,
              chunk=12)


def test_page_exhaustion_backpressure_matches(models):
    """A pool too small for every slot: admission blocks on the page
    budget (not on free slots), FCFS head-of-line, and both engines
    block on the same steps."""
    rng = np.random.default_rng(3)
    lens = [20, 18, 22, 6, 19, 21]
    gens = [5, 6, 4, 3, 6, 5]
    prompts = [rng.integers(0, 256, size=(n,)) for n in lens]
    js, ts = _run_both(models, prompts, gens, n_slots=4, page_size=8,
                       n_pages=7, chunk=16, stagger=6)
    assert ts["admit_rejects"] == js["admit_rejects"] > 0
    assert ts["max_committed_pages"] <= 7
    assert ts["mean_occupancy"] == pytest.approx(js["mean_occupancy"])


def test_req_ids_after_a_rejected_submit_match(models):
    """A request that needs more positions than max_len passes the
    arena's page check (n_pages 64) but is refused by the scheduler in
    both engines; the id it was given is spent in both, so the next
    request's req_id and tokens agree."""
    jlm, jt, tlm, tt = models
    j_eng = JServingEngine(jlm, jt, JServingConfig(
        n_slots=2, max_len=MAX_LEN, paged=True, page_size=8, n_pages=64,
        paged_kernel=False, scheduler=JSchedulerConfig(prefill_chunk=16)))
    t_eng = ServingEngine(tlm, tt, ServingConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8, n_pages=64, device="cpu",
        scheduler=SchedulerConfig(prefill_chunk=16)))
    rng = np.random.default_rng(4)
    long_prompt = rng.integers(0, 256, size=(60,))
    prompt = rng.integers(0, 256, size=(5,))
    results = []
    for eng in (j_eng, t_eng):
        with pytest.raises(ValueError, match="positions"):
            eng.submit(long_prompt, 10)
        rid = eng.submit(prompt, 6)
        done = eng.run_until_drained()
        results.append((rid, [(c.req_id, list(c.tokens)) for c in done]))
    assert results[0] == results[1]
    assert results[1][0] == 1 and len(results[1][1][0][1]) == 6
