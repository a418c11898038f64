"""The MoE family in the port against the JAX reference: `QMoE`, the
block with experts, reduced olmoe_1b_7b end to end, and the grouped
int8 GEMM's plain version.

Held at tolerance 0 unless stated:

  - the routing island (`QMoE._route`): gate images round(127 g), expert
    picks, slot positions and the token-for-slot table equal the
    reference's on seeded logits, capacity drops included; over a sweep
    of seeded router accumulators at olmoe's width (64 experts, top-8,
    groups of 512) the number of gate images and expert picks that
    differ from `jax.nn.softmax` + `jax.lax.top_k` is counted and must
    be 0 (bit equality is not built in: the port's softmax is its own
    fixed-order float32 island);
  - `QMoE.apply_float` within 1e-5 of max |ref|, its five observed
    ranges within 1e-5 of the span; `deploy` leaf for leaf; `apply_id`;
  - the grouped GEMM's plain version against the reference's einsum and
    requant, and its launch plan;
  - reduced olmoe_1b_7b: calibrate within 1e-5 of the span, deploy from
    the port's own calibration equal to the reference's, the
    layer-by-layer `deploy_model` equal to the whole-model deploy, the
    expert weights' stored layout;
  - its tokens in exact mode over the slot arena and the paged one, at
    dispatch depth 0 and 1 and with scripted preemptions (re-prefill
    resume), lockstep with the reference engine (`paged_kernel=False`
    where paged), arena state after every step;
  - the reference's two quirks, raised as it raises them: a group that
    does not divide the tokens (the entry point's 4 x 63-token
    calibration sample at max_seq 64; an exact-mode prompt longer than
    `moe_group` and not a multiple of it);
  - what the reference still refuses of the MoE plans (moe_every 2 at
    an odd n_layers, moe_every 3) and `param_count` (falcon_mamba_7b's
    too).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.rep import Rep
from repro.core.requant import apply_rqt as j_apply_rqt
from repro.launch.serve import deploy_model as j_deploy_model
from repro.layers.common import DeployCtx as JDeployCtx
from repro.layers.moe import QMoE as JQMoE, _expand as j_expand
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.kernels import int8_matmul_grouped, int8_matmul_grouped_plain
from repro_torch.kernels.int8_matmul import SMS, gemm_plan
from repro_torch.launch.serve import calibration_sample, deploy_model
from repro_torch.layers.common import DeployCtx
from repro_torch.layers.moe import QMoE
from repro_torch.models.blocks import DenseBlock
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy, tree_to_torch,
)
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine, SlotArena,
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


TOL = 1e-5  # of max |ref| (outputs) and of the reference's span (ranges)
MAX_LEN = 128  # the reduced olmoe's deploy needs 4 x 64 calibration tokens
ARCH = "olmoe_1b_7b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_tree(ref, got, path=""):
    if isinstance(ref, dict):
        keys = set(ref)
        assert set(got) == keys, (path, set(got) ^ keys)
        for k in keys:
            _same_tree(ref[k], got[k], f"{path}/{k}")
        return
    if isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _same_tree(r, g, f"{path}/{i}")
        return
    a = np.asarray(ref)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=path)


# -- the routing island --------------------------------------------------
def _route_both(E, k, group, logits):
    j = JQMoE(64, 64, E, k, group_size=group)
    t = QMoE(64, 64, E, k, group_size=group)
    jg, je, jp, jt, jc = j._route(jnp.asarray(logits))
    tg, te, tp, tt, tc = t._route(torch.from_numpy(logits))
    return (np.asarray(jg), np.asarray(je), np.asarray(jp), np.asarray(jt),
            jc), (tg.numpy(), te.numpy(), tp.numpy(), tt.numpy(), tc)


@pytest.mark.parametrize("G,Gs,E,k,skew", [
    (2, 64, 4, 2, 0.0), (1, 8, 64, 8, 0.0), (1, 512, 64, 8, 0.0),
    (3, 40, 16, 4, 3.0), (1, 254, 64, 8, 2.0)])
def test_route_equals_reference(G, Gs, E, k, skew):
    """Gate images, expert picks, slots, the token-for-slot table and C;
    `skew` favours the low experts so capacity drops tokens."""
    rng = np.random.default_rng(G * 1000 + Gs + E)
    logits = rng.standard_normal((G, Gs, E)).astype(np.float32)
    logits += np.float32(skew) * np.linspace(1, 0, E, dtype=np.float32)
    ref, got = _route_both(E, k, Gs, logits)
    assert got[4] == ref[4]
    np.testing.assert_array_equal(np.round(got[0] * 127.0),
                                  np.round(ref[0] * 127.0))
    for a, b in zip(ref[1:4], got[1:4]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=0)
    if skew:
        assert (ref[0] == 0).any()  # capacity dropped some picks


def test_routing_island_sweep_counts_no_difference():
    """Seeded router accumulators at olmoe's width: r_acc int32 times a
    per-expert float32 scale, as `apply_id` forms them; every gate image
    and expert pick against the reference's island."""
    E, k, Gs = 64, 8, 512
    images = picks = 0
    total = 0
    for seed in range(24):
        rng = np.random.default_rng(100 + seed)
        r_acc = rng.integers(-(1 << 20), 1 << 20, size=(1, Gs, E))
        scale = rng.uniform(1e-6, 4e-6, size=E).astype(np.float32)
        logits = r_acc.astype(np.float32) * scale
        ref, got = _route_both(E, k, Gs, logits)
        images += int((np.round(got[0] * 127) != np.round(ref[0] * 127))
                      .sum())
        picks += int((got[1] != ref[1]).sum())
        total += got[1].size
    print(f"routing island: {images} gate images and {picks} expert picks "
          f"of {total} differ from jax.nn.softmax + jax.lax.top_k")
    assert images == 0 and picks == 0


# -- QMoE, one layer -----------------------------------------------------
def _layer(E=4, k=2, d=128, f=256, group=64, T=256, seed=1):
    j = JQMoE(d, f, E, k, group_size=group)
    t = QMoE(d, f, E, k, group_size=group)
    p = j.init(jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)
    return j, t, p, x


@pytest.mark.parametrize("E,k,d,f", [(4, 2, 128, 256), (64, 8, 64, 96)])
def test_qmoe_float_deploy_and_apply_id_equal_reference(E, k, d, f):
    j, t, p, x = _layer(E, k, d, f)
    jc, tc = JCalibrator(), Calibrator()
    yj, _ = j.apply_float(p, jnp.asarray(x), Rep.FP, calib=jc, scope="s.")
    yt, _ = t.apply_float(params_to_torch(_np(p), "cpu"),
                          torch.from_numpy(x), calib=tc, scope="s.")
    yj = np.asarray(yj)
    assert float(np.max(np.abs(yt.numpy() - yj))) <= TOL * float(
        np.max(np.abs(yj)))
    assert list(tc.hi) == list(jc.hi) and len(jc.hi) == 5
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n
    # deploy from the reference's ranges: leaf for leaf
    tj, ej = j.deploy(JDeployCtx(calib=jc), "s.", _np(p), 0.05, 0)
    tt, et = t.deploy(DeployCtx(calib=jc), "s.", _np(p), 0.05, 0)
    _same_tree(tj, tt)
    assert et.tolist() == np.asarray(ej).tolist()
    s = np.clip(np.round(x / 0.05), -128, 127).astype(np.int8)
    want = np.asarray(j.apply_id(jax.tree.map(jnp.asarray, tj),
                                 jnp.asarray(s)))
    got = t.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_that_does_not_divide_raises_as_the_reference_asserts():
    j, t, _, _ = _layer()
    x = np.zeros((252, 128), np.float32)
    with pytest.raises(AssertionError):
        j._group(jnp.asarray(x))
    with pytest.raises(ValueError, match=r"\(252, 64\)"):
        t._group(torch.from_numpy(x))
    assert t._group(torch.zeros((40, 128)))[1] == 40  # one group under 64


# -- the grouped int8 GEMM's plain version --------------------------------
@pytest.mark.parametrize("per_expert", [True, False])
def test_grouped_plain_equals_reference_einsum_and_requant(per_expert):
    from repro_torch.core.requant import make_rqt

    rng = np.random.default_rng(5)
    G, E, C, K, N = 2, 3, 5, 2100, 24
    x = rng.integers(-128, 128, size=(G, E, C, K)).astype(np.int8)
    w = rng.integers(-128, 128, size=(E, K, N)).astype(np.int8)
    eps = rng.uniform(1e-5, 4e-5, size=(E, N) if per_expert else N)
    rqt = make_rqt(eps, 0.05, acc_bound=K * 127.0 * 127.0)
    acc = jnp.einsum("gecd,edf->gecf", jnp.asarray(x), jnp.asarray(w),
                     preferred_element_type=jnp.int32)
    want = np.asarray(j_apply_rqt(acc, j_expand(
        jax.tree.map(jnp.asarray, rqt), 1)))
    tw = tree_to_torch({"wg_q": w}, "cpu")["wg_q"]
    assert tw.stride() == (N * K, 1, K)  # stored (E, N, K)
    rq = {k_: torch.from_numpy(np.asarray(v)) for k_, v in rqt.items()}
    n = int8_matmul_grouped.launches
    got = int8_matmul_grouped(torch.from_numpy(x), tw, rq)
    assert int8_matmul_grouped.launches == n  # the CPU runs the plain one
    np.testing.assert_array_equal(got.numpy(), want)
    got32 = int8_matmul_grouped_plain(torch.from_numpy(x), tw)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(acc))


@pytest.mark.parametrize("C,K,N", [(4, 2048, 1024), (4, 1024, 2048),
                                   (40, 2048, 1024), (80, 1024, 2048)])
def test_grouped_plan_fills_the_card_at_olmoe_sites(C, K, N):
    """One launch over 64 groups: the GEMV at decode's C 4, wgmma above
    16, at least a wave of blocks and no split of K; the dense plan is
    the one-group plan."""
    p = gemm_plan(C, N, K, 64)
    assert p.path == ("gemv" if C <= 16 else "wgmma")
    assert p.blocks >= SMS and p.splits == 1
    assert gemm_plan(C, N, K) == gemm_plan(C, N, K, 1)


# -- reduced olmoe_1b_7b end to end --------------------------------------
_CACHE = {}


def _reference():
    """The reference's lm, params and calibrator as its deploy_model
    builds them (PRNGKey(0), the entry point's sample), and the port's
    calibrator on the same params."""
    if "ref" not in _CACHE:
        cfg = j_get_config(ARCH).reduced()
        jlm = JLM(cfg, max_seq=MAX_LEN)
        p = jlm.init(jax.random.PRNGKey(0))
        sample = calibration_sample(cfg.vocab, MAX_LEN)
        jc = jlm.calibrate(p, jnp.asarray(sample))
        tlm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
        tc = tlm.calibrate(_np(p), sample, device="cpu")
        _CACHE["ref"] = (jlm, p, jc, tlm, tc, sample)
    return _CACHE["ref"]


def _deploy_diff(ref, got, path="", out=None):
    """Compare two deploys of one model: float leaves within rtol 1e-5
    (quanta formed in another float64 order may differ in the last ulp),
    integer leaves equal, except a requant multiplier `m` off by one
    (its calibrated range within TOL of the reference's, the float64
    ratio on the other side of an integer) together with the pre-clip
    bounds that follow from it at the same entries.  -> those entries."""
    out = [] if out is None else out
    if isinstance(ref, dict):
        if "m" in ref and "lo" in ref:
            m_a, m_b = np.asarray(ref["m"]), np.asarray(got["m"])
            assert m_a.shape == m_b.shape, path
            assert int(np.max(np.abs(m_a.astype(np.int64) - m_b))) <= 1, path
            off = m_a != m_b
            for k in ref:
                a, b = np.asarray(ref[k]), np.asarray(got[k])
                assert a.dtype == b.dtype and a.shape == b.shape, path
                if k in ("lo", "hi"):
                    np.testing.assert_array_equal(b[~off], a[~off],
                                                  err_msg=f"{path}/{k}")
                elif k != "m":
                    np.testing.assert_array_equal(b, a,
                                                  err_msg=f"{path}/{k}")
            out.extend(f"{path}{tuple(map(int, i))}"
                       for i in np.argwhere(off))
            return out
        keys = set(ref)
        assert set(got) == keys, path
        for k in sorted(keys):
            _deploy_diff(ref[k], got[k], f"{path}/{k}", out)
        return out
    if isinstance(ref, list):
        for i, (r, g) in enumerate(zip(ref, got)):
            _deploy_diff(r, g, f"{path}/{i}", out)
        return out
    a, b = np.asarray(ref), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=path)
    else:
        np.testing.assert_array_equal(b, a, err_msg=path)
    return out


def test_olmoe_calibrate_and_deploy_equal_reference():
    """The port's calibration of the reference's params within TOL of
    the span; its deploy from the reference's ranges equal to the
    reference's (float quanta within rtol 1e-5), and from its own
    ranges equal but at calibration boundaries (counted)."""
    jlm, p, jc, tlm, tc, _ = _reference()
    assert list(tc.hi) == list(jc.hi)
    assert sum(".moe." in n for n in jc.hi) == 5 * tlm.cfg.n_layers
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n
    ref = _np(jlm.deploy(p, jc))
    assert _deploy_diff(ref, tlm.deploy(_np(p), jc)) == []
    off = _deploy_diff(ref, tlm.deploy(_np(p), tc))
    print(f"requant multipliers on a calibration boundary: {off}")
    assert len(off) <= 8


def test_olmoe_layer_by_layer_deploy_model_equals_whole_tree():
    lm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    p = lm.init_np(5)
    calib = lm.calibrate(p, calibration_sample(lm.cfg.vocab, MAX_LEN),
                         device="cpu")
    whole = tables_from_numpy(lm.deploy(p, calib), device="cpu")
    _, streamed = deploy_model(ARCH, reduced=True, max_seq=MAX_LEN, seed=5,
                               device="cpu")

    def eq(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                eq(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.stride() == b.stride(), path
            assert torch.equal(a, b), path
        else:
            assert a == b, path

    eq(whole, streamed)
    moe = streamed["layers"][0]["moe"]
    E, d, f = 4, 128, 256
    assert moe["wg_q"].shape == (E, d, f) and moe["wg_q"].stride() == (
        d * f, 1, d)
    assert moe["wd_q"].shape == (E, f, d) and moe["wd_q"].stride() == (
        f * d, 1, f)
    assert moe["g_rqt"]["m"].shape == (E, f)
    assert moe["router_scale"].dtype == torch.float32


def test_calibration_quirk_at_max_seq_64_raises_on_both_sides():
    """The entry point's 4 x 63-token sample is 252 tokens, not a
    multiple of the reduced group 64: the reference asserts, the port
    raises ValueError at the same place."""
    with pytest.raises(AssertionError, match="252, 64"):
        j_deploy_model(ARCH, reduced=True, max_seq=64)
    with pytest.raises(ValueError, match=r"\(252, 64\)"):
        deploy_model(ARCH, reduced=True, max_seq=64, device="cpu")


@pytest.fixture(scope="module")
def served():
    """The reference's deploy_model tables, carried across."""
    jlm, jt = j_deploy_model(ARCH, reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    return jlm, jt, tlm, tables_from_numpy(_np(jt), device="cpu")


def _engines(served, *, paged, depth=0, policy=None, n_slots=3):
    jlm, jt, tlm, tt = served
    kw = dict(n_slots=n_slots, max_len=MAX_LEN, dispatch_depth=depth)
    if paged:
        kw.update(paged=True, page_size=8)
    j = JServingEngine(jlm, jt, JServingConfig(
        policy=policy() if policy else None,
        paged_kernel=False if paged else None,
        scheduler=JSchedulerConfig(), **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        device="cpu", policy=policy() if policy else None,
        scheduler=SchedulerConfig(), **kw))
    return j, t


WORK = [(5, 6), (17, 5), (33, 6), (40, 4), (1, 6), (64, 5), (9, 6)]


def _state(a):
    s = {"owner": list(a.owner), "lengths": a.lengths.tolist(),
         "n_free": a.n_free}
    if hasattr(a, "page_table"):
        s["page_table"] = a.page_table.tolist()
    return s


def _step_both(j, t):
    """One step of each engine: equal results (or the same error), and
    equal arena state after it."""
    out = []
    for eng in (j, t):
        try:
            out.append(eng.step())
        except RuntimeError as e:
            out.append(("raised", str(e)))
    assert out[0] == out[1]
    assert _state(t.arena) == _state(j.arena)
    return out[0]


def _lockstep(j, t, vocab, seed=0):
    """Submit one request and step, then drain, both engines together.
    -> (reference, port) completions, or ("raised", message) where a
    step of the reference raised (the port's raised the same)."""
    rng = np.random.default_rng(seed)
    work = [(rng.integers(0, vocab, size=(n,)), g) for n, g in WORK]
    for prompt, g in work:
        for eng in (j, t):
            eng.submit(copy.deepcopy(prompt), max_new_tokens=g)
        res = _step_both(j, t)
        if isinstance(res, tuple):
            return res
    steps = 0
    while (j.sched.n_pending or j.active or j.queue.pending
           or t.sched.n_pending or t.active or t.queue.pending):
        res = _step_both(j, t)
        if isinstance(res, tuple):
            return res
        steps += 1
        assert steps < 200
    return [[(c.req_id, list(map(int, c.tokens)), c.finish_reason,
              c.n_preempts) for c in eng.completed] for eng in (j, t)]


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("paged", [False, True])
def test_olmoe_tokens_equal_reference_in_exact_mode(served, paged, depth):
    j, t = _engines(served, paged=paged, depth=depth)
    assert t._prefill_mode == j._prefill_mode == "exact"
    assert isinstance(t.arena, SlotArena) != paged
    ref, got = _lockstep(j, t, served[2].cfg.vocab)
    assert got == ref
    assert sorted(len(toks) for _, toks, _, _ in got) == sorted(
        g for _, g in WORK)
    assert t.stats()["steps"] == j.stats()["steps"]
    if not paged:
        for kv in ("k", "v"):
            np.testing.assert_array_equal(
                t.arena.caches[kv][:, 1:].numpy(),
                np.asarray(j.arena.caches[0][kv]))


# (seed, script): over the slot arena at depth 0, a preemption whose
# resume the reference's oracle rejects, and one it accepts
PREEMPT_CASES = ((0, {2: "active"}), (0, {3: "active"}))


@pytest.mark.parametrize("paged,depth", [(False, 0), (True, 1)])
def test_olmoe_scripted_preemption_as_the_reference(served, paged, depth):
    """Scripted evictions of decodes mid-generation.  A victim
    re-prefills prompt + tokens[:-1] at batch 1 as one routing group,
    where its tokens were decoded beside the other slots' rows, so
    capacity drops may differ and the re-prefill may not regenerate
    tokens[-1]: the reference's resume oracle then raises, and the
    port's raises the same at the same step; where every resume holds,
    both finish with equal tokens and preemption counts."""
    outcomes = []
    for seed, script in PREEMPT_CASES:
        j, t = _engines(served, paged=paged, depth=depth,
                        policy=lambda: ScriptedPreemptions(script))
        res = _lockstep(j, t, served[2].cfg.vocab, seed=seed)
        if isinstance(res, tuple):
            assert "resume parity violated" in res[1]
            outcomes.append("raised")
            continue
        ref, got = res
        assert got == ref
        assert t.stats()["n_preempts"] == j.stats()["n_preempts"] > 0
        outcomes.append("resumed")
    print(f"olmoe scripted preemption, paged {paged}, depth {depth}: "
          f"{outcomes}")
    if not paged and depth == 0:
        assert outcomes == ["raised", "resumed"]


def test_olmoe_port_deploy_serves_as_the_reference_engine():
    """The port's deploy (init_np, its own calibration: what
    `deploy_model` gives layer by layer) served by both engines in exact
    mode over the slot arena: equal tokens."""
    lm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    p = lm.init_np(0)
    t_np = lm.deploy(p, lm.calibrate(
        p, calibration_sample(lm.cfg.vocab, MAX_LEN), device="cpu"))
    jlm = JLM(j_get_config(ARCH).reduced(), max_seq=MAX_LEN)
    pair = (jlm, jax.tree.map(jnp.asarray, t_np), lm,
            tables_from_numpy(t_np, device="cpu"))
    j, t = _engines(pair, paged=False)
    ref, got = _lockstep(j, t, lm.cfg.vocab, seed=5)
    assert got == ref


def test_exact_prompt_over_the_group_raises_as_the_reference(served):
    """A 70-token prompt is longer than the reduced group 64 and not a
    multiple of it: the reference's prefill asserts, the port's raises
    ValueError."""
    prompt = np.arange(70) % 200
    j, t = _engines(served, paged=False)
    j.submit(prompt, max_new_tokens=2)
    t.submit(prompt, max_new_tokens=2)
    with pytest.raises(AssertionError):
        j.step()
    with pytest.raises(ValueError, match=r"\(70, 64\)"):
        t.step()


# -- guards and counts ---------------------------------------------------
def test_unported_moe_variants_and_families_raise():
    """What the reference still refuses of the MoE plans: moe_every 2 at
    an odd n_layers (its plan asserts; the port raises ValueError at
    construction) and moe_every 3 (ValueError in both).  The shared
    expert is ported: a block with experts carries it, a block without
    ignores it, as the reference's `_subs` does."""
    base = get_config(ARCH).reduced()
    jbase = j_get_config(ARCH).reduced()
    for kw, match in ((dict(moe_every=2, n_layers=3), "must be even"),
                      (dict(moe_every=3), "moe_every 3")):
        with pytest.raises((AssertionError, ValueError)):
            JLM(dataclasses.replace(jbase, **kw)).plan()
        with pytest.raises(ValueError, match=match):
            DecoderLM(dataclasses.replace(base, **kw))
    assert DecoderLM(dataclasses.replace(base, moe_every=2)).pair
    blk = DenseBlock(128, 4, 2, 32, 256, n_experts=4, shared_expert=True)
    assert blk.ffns == ("moe", "mlp") and blk._subs()["mlp"].name == (
        "shared_mlp")
    dense = DenseBlock(128, 4, 2, 32, 256, shared_expert=True)
    assert dense.ffns == ("mlp",) and dense._subs()["mlp"].name == "mlp"


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "granite_3_2b",
                                  "musicgen_medium", "nemotron_4_340b",
                                  "falcon_mamba_7b", "zamba2_1_2b",
                                  "internvl2_76b"])
def test_config_and_param_count_equal_reference(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    jr, tr = j.reduced(), t.reduced()
    for f in dataclasses.fields(tr):
        assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    assert isinstance(t, ArchConfig)
