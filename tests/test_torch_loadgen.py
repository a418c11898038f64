"""The port's open-loop load generator against the JAX reference's.

The arrival schedules and workloads are host numpy, so they must equal
the reference's byte for byte for the same seed.  `run_open_loop`
drives each engine on an explicit arrival trace: the port's tokens must
equal the reference engine's (`paged=True, paged_kernel=False`) and the
port's own closed-loop run of the same requests; only timing may
differ.  The SLO roll-up's arithmetic is held on hand-made
completions, where no clock enters.
"""
import copy

import jax
import numpy as np
import pytest

from repro.launch.serve import deploy_model as j_deploy_model
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro.serving import loadgen as jlg
from repro.serving.request import (
    Completion as JCompletion, Request as JRequest,
)
from repro_torch.configs.base import get_config
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    Request, SchedulerConfig, ServingConfig, ServingEngine, loadgen,
)
from repro_torch.serving.request import Completion

MAX_LEN = 48


@pytest.mark.parametrize("seed,n,rate", [(0, 1, 0.5), (1, 16, 3.0),
                                         (7, 64, 250.0)])
def test_poisson_arrivals_equal_reference(seed, n, rate):
    got = loadgen.poisson_arrivals(n, rate, np.random.default_rng(seed))
    want = jlg.poisson_arrivals(n, rate, np.random.default_rng(seed))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("n,rate", [(0, 1.0), (3, 0.0), (3, -2.0)])
def test_poisson_arrivals_errors_equal_reference(n, rate):
    msgs = []
    for mod in (loadgen, jlg):
        with pytest.raises(ValueError) as e:
            mod.poisson_arrivals(n, rate, np.random.default_rng(0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("offsets", [[0.0], [0.3, 0.0, 0.1, 0.1],
                                     (2, 1, 5), np.arange(4.0)[::-1]])
def test_trace_arrivals_equal_reference(offsets):
    got = loadgen.trace_arrivals(offsets)
    want = jlg.trace_arrivals(offsets)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("offsets", [[], [[0.0, 1.0]], [0.5, -0.1]])
def test_trace_arrivals_errors_equal_reference(offsets):
    msgs = []
    for mod in (loadgen, jlg):
        with pytest.raises(ValueError) as e:
            mod.trace_arrivals(offsets)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n,prefix,suffix", [(1, 0, 5), (4, 12, 3),
                                             (6, 7, 0)])
def test_shared_prefix_workload_equals_reference(n, prefix, suffix):
    kw = dict(prefix_len=prefix, suffix_len=suffix, max_new_tokens=5)
    got = loadgen.shared_prefix_workload(n, 256, np.random.default_rng(3),
                                         **kw)
    want = jlg.shared_prefix_workload(n, 256, np.random.default_rng(3), **kw)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert isinstance(g, Request)
        assert g.prompt.dtype == w.prompt.dtype
        assert g.prompt.tobytes() == w.prompt.tobytes()
        assert g.max_new_tokens == w.max_new_tokens
        assert g.prompt[:prefix].tobytes() == got[0].prompt[:prefix].tobytes()


@pytest.mark.parametrize("n,prefix,suffix", [(0, 2, 2), (2, -1, 2),
                                             (2, 2, -1)])
def test_shared_prefix_workload_errors_equal_reference(n, prefix, suffix):
    msgs = []
    for mod in (loadgen, jlg):
        with pytest.raises(ValueError) as e:
            mod.shared_prefix_workload(
                n, 256, np.random.default_rng(0), prefix_len=prefix,
                suffix_len=suffix, max_new_tokens=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _engines(models):
    jlm, jt, tlm, tt = models
    j_eng = JServingEngine(jlm, jt, JServingConfig(
        n_slots=3, max_len=MAX_LEN, paged=True, page_size=8, n_pages=12,
        paged_kernel=False, scheduler=JSchedulerConfig(prefill_chunk=8)))
    t_eng = ServingEngine(tlm, tt, ServingConfig(
        n_slots=3, max_len=MAX_LEN, paged=True, page_size=8, n_pages=12,
        device="cpu",
        scheduler=SchedulerConfig(prefill_chunk=8)))
    return j_eng, t_eng


# arrivals (seconds): a burst, a gap the engine drains in, a late pair
TRACE = [0.0, 0.0, 0.001, 0.002, 0.05, 0.3, 0.3, 0.31]


@pytest.mark.parametrize("shared", [False, True])
def test_run_open_loop_tokens_equal_reference_and_closed_loop(models,
                                                             shared):
    vocab = models[2].cfg.vocab
    rng = np.random.default_rng(11)
    if shared:
        reqs = loadgen.shared_prefix_workload(
            len(TRACE), vocab, rng, prefix_len=10, suffix_len=6,
            max_new_tokens=4)
    else:
        reqs = [Request(rng.integers(0, vocab, size=(int(p),)),
                        max_new_tokens=int(g))
                for p, g in zip(rng.integers(1, 30, size=len(TRACE)),
                                rng.integers(1, 9, size=len(TRACE)))]
    j_reqs = [JRequest(r.prompt.copy(), r.max_new_tokens) for r in reqs]
    arrivals = loadgen.trace_arrivals(TRACE)
    j_eng, t_eng = _engines(models)
    kw = dict(slo_ttft_s=30.0, slo_itl_s=30.0)
    got = loadgen.run_open_loop(t_eng, copy.deepcopy(reqs), arrivals, **kw)
    want = jlg.run_open_loop(j_eng, j_reqs, jlg.trace_arrivals(TRACE), **kw)

    def tokens(res):
        return {c.req_id: list(c.tokens) for c in res.completions}

    assert tokens(got) == tokens(want)
    assert got.n_requests == got.n_completed == len(TRACE)
    for k in ("n_requests", "n_completed", "offered_qps", "slo_ttft_s",
              "slo_itl_s", "n_preempts"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.sustained is True and got.slo_attainment == 1.0
    d = got.to_dict()
    assert set(d) == set(want.to_dict()) and "completions" not in d
    # the port's closed loop on the same requests: the same tokens
    _, closed = _engines(models)
    for r in copy.deepcopy(reqs):
        closed.submit(r)
    assert tokens(got) == {c.req_id: list(c.tokens)
                           for c in closed.run_until_drained()}
    # the run advanced the engine's own window
    assert t_eng.stats()["n_completed"] == len(TRACE)


def test_run_open_loop_rejects_a_length_mismatch(models):
    _, t_eng = _engines(models)
    with pytest.raises(ValueError, match="2 requests but 1 arrivals"):
        loadgen.run_open_loop(
            t_eng, [Request(np.arange(3), 2), Request(np.arange(4), 2)],
            [0.0])


# hand-made completions: (arrival, admit, first token, emit gaps)
_COMPS = [(0.0, 0.1, 0.5, [0.1, 0.1, 0.4]), (0.2, 0.2, 0.4, [0.05]),
          (0.3, 0.9, 1.7, []), (1.0, 1.1, 1.3, [0.2, 0.9, 0.2, 0.2]),
          (1.5, 1.5, 1.6, [0.01] * 12)]


def _completions(cls):
    out = []
    for i, (arr, adm, first, gaps) in enumerate(_COMPS):
        emits = list(first + np.cumsum([0.0] + gaps))
        out.append(cls(req_id=i, prompt_len=4, tokens=list(range(len(emits))),
                       finish_reason="length", arrival_time=arr,
                       first_token_time=first, finish_time=emits[-1],
                       admit_time=adm, emit_times=emits))
    return out


class _Replay:
    """A stand-in engine whose i-th submit completes the i-th hand-made
    completion at once: run_open_loop's roll-up over known numbers."""

    def __init__(self, comps):
        self._comps = list(comps)
        self.completed = []
        self.sched = type("S", (), {"n_pending": 0})()
        self.queue = type("Q", (), {"pending": 0})()
        self.prefilling, self.active = {}, {}

    def submit(self, req):
        self.completed.append(self._comps[len(self.completed)])

    def step(self):
        return False

    def stats(self):
        return {"n_preempts": 0}


SLOS = [(None, None), (0.5, None), (None, 0.3), (0.8, 0.35), (0.05, 0.01),
        (10.0, 10.0)]


@pytest.mark.parametrize("slo_ttft,slo_itl", SLOS)
def test_slo_rollup_equals_reference(slo_ttft, slo_itl):
    tc, jc = _completions(Completion), _completions(JCompletion)
    for c, j in zip(tc, jc):
        assert loadgen._request_meets_slo(c, slo_ttft, slo_itl) == \
            jlg._request_meets_slo(j, slo_ttft, slo_itl)
    arrivals = [0.0, 0.0, 0.001, 0.001, 0.002]
    reqs = [Request(np.arange(3), 2) for _ in arrivals]
    got = loadgen.run_open_loop(_Replay(tc), reqs, arrivals,
                                slo_ttft_s=slo_ttft, slo_itl_s=slo_itl)
    want = jlg.run_open_loop(_Replay(jc), reqs, arrivals,
                             slo_ttft_s=slo_ttft, slo_itl_s=slo_itl)
    for k in ("n_requests", "n_completed", "offered_qps", "slo_attainment",
              "p50_ttft_s", "p99_ttft_s", "p99_itl_s", "sustained",
              "n_preempts"):
        assert getattr(got, k) == getattr(want, k), k
    met = sum(loadgen._request_meets_slo(c, slo_ttft, slo_itl) for c in tc)
    assert got.goodput_qps * got.wall_s == pytest.approx(met)
    assert got.completed_qps * got.wall_s == pytest.approx(len(tc))
