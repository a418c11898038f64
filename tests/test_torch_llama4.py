"""llama4_maverick_400b_a17b in the port against the JAX reference: the
"pair" segment (a dense block, then a MoE block) and the shared expert
beside the routed experts, through FP, FQ, deploy, ID serving and FQ
training.

Held here (reduced llama4: one pair, d 128, 4 experts top-1 with a
shared gated MLP, MoE groups of 64; the reference's params from
PRNGKey(0), carried across with `params_to_torch`):

  - `DenseBlock` with the shared expert: the FP forward within TOL of
    max |ref| and its observed ranges (the shared MLP's under ``sh.``)
    within TOL of the span, the FQ forward within TOL, the deploy
    from the reference's calibrator leaf for leaf (`sh_rqt` included)
    and `apply_id` at tolerance 0;
  - `sh_rqt` at the published d_ff 8192 (acc_bound 8192 * 127^2) over
    a sweep of ratios: the same ratios schedule in both packages, with
    equal tables, and the rest raise the same ValueError;
  - the whole model: the float tree's paths and shapes and the qstate's
    equal the reference's, the FP logits within TOL, the calibration
    within TOL of the span; the deploy from the 4 x 32 sample leaf for
    leaf, from the port's own calibration too; the 2 x 16 sample's and
    `deploy_model`'s raises where the reference raises;
  - prefill and decode at tolerance 0;
  - the engine over the slot arena and the paged arena (the reference
    at `paged_kernel=False`; dispatch depth 0 and 1): tokens, finish
    reasons, steps and arena state after every step; at kv_bits 4 both
    engines refuse the MoE family's exact-length prefill alike, and one
    `prefill_chunk` over int8 and int4-packed pools of the pair (a chunk
    and a decode) equals the reference's, logits and pools;
  - the FQ train step: the loss and every gradient leaf within 1.5x the
    reference's own jit-vs-op-by-op gap, as olmoe is held.

MEASURED (on the CPU): the block's FP and FQ outputs 4.2e-7 and 3.2e-7
of max |ref| apart; 237 of the 400 sh_rqt ratios schedule.
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
from repro.core.rep import Rep as JRep
from repro.core.requant import make_rqt as j_make_rqt
from repro.launch.serve import deploy_model as j_deploy_model
from repro.launch.train import build as j_build
from repro.layers.common import DeployCtx as JDeployCtx
from repro.models.blocks import DenseBlock as JDenseBlock
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import (
    LM_ARCH_IDS, SERVE_ARCH_IDS, get_config,
)
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
from repro_torch.launch.serve import deploy_model
from repro_torch.launch.steps import value_and_grad
from repro_torch.launch.train import build
from repro_torch.layers.common import DeployCtx
from repro_torch.models.blocks import SHARED_RANGE, DenseBlock
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy, tree_to_torch,
)
from repro_torch.serving import SchedulerConfig, ServingConfig, ServingEngine
from test_torch_moe import _deploy_diff, _same_tree
from test_torch_train_moe import check_against_both_runs

ARCH = "llama4_maverick_400b_a17b"
TOL = 1e-5      # of max |ref| (outputs) and of the reference's span (ranges)
MAX_LEN = 128
SAMPLE = (4, 32)  # the calibration sample the reference deploys from


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sample(B, S, vocab=256):
    return SyntheticStream(SyntheticConfig(
        vocab=vocab, seq_len=S, global_batch=B)).batch(0)[:, :S]


def _span_close(jc, tc):
    assert list(tc.hi) == list(jc.hi)
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n


def _close(want, got, tol):
    want = np.asarray(want, np.float32)
    assert float(np.max(np.abs(got - want))) <= tol * float(
        np.max(np.abs(want)))


# -- the block with the shared expert ----------------------------------------
BLOCK = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
             rope_base=500000.0, max_seq=64, n_experts=4, top_k=1,
             moe_group=64, shared_expert=True)


@pytest.fixture(scope="module")
def block():
    """The reference's block (params, calibrator on a 2 x 32 input) and
    the port's calibrator on the same."""
    jb, tb = JDenseBlock(**BLOCK), DenseBlock(**BLOCK)
    p = _np(jb.init(jax.random.PRNGKey(3)))
    x = np.random.default_rng(3).standard_normal((2, 32, 128)).astype(
        np.float32)
    jc, tc = JCalibrator(), Calibrator()
    yj, _, aj = jb.apply_float(p, jnp.asarray(x), JRep.FP, calib=jc,
                               scope="s.")
    aux = []
    yt = tb.apply_float(params_to_torch(p, "cpu"), torch.from_numpy(x), tc,
                        "s.", aux=aux)
    return jb, tb, p, x, jc, tc, (yj, aj), (yt, aux)


def test_block_float_forward_equals_reference(block):
    jb, tb, p, x, jc, tc, (yj, aj), (yt, aux) = block
    assert tb.ffns == ("moe", "mlp")
    assert set(p) == {"norm1", "attn", "norm2", "moe", "mlp"}
    _close(yj, yt.numpy(), TOL)
    assert len(aux) == 1 and abs(float(aux[0]) - float(aj)) <= TOL * abs(
        float(aj))
    assert sum(n.startswith("s.sh.shared_mlp.") for n in jc.hi) == 4
    _span_close(jc, tc)
    # FQ on the reference's clips (the shared MLP's beside the MoE's)
    qs = jb.init_qstate()
    assert set(qs) == {"mlp", "moe"}
    yq, _, _ = jb.apply_float(p, jnp.asarray(x), JRep.FQ, qs=qs)
    tq = tb.apply_float(params_to_torch(p, "cpu"), torch.from_numpy(x),
                        rep=Rep.FQ, qs=params_to_torch(_np(qs), "cpu"))
    assert set(tb.init_qstate("cpu")) == {"mlp", "moe"}
    _close(yq, tq.numpy(), TOL)


def test_block_deploy_and_apply_id_equal_reference(block):
    jb, tb, p, x, jc, _, _, _ = block
    tj, ej = jb.deploy(JDeployCtx(calib=jc), "s.", p, 0.05)
    tt, et = tb.deploy(DeployCtx(calib=jc), "s.", p, 0.05)
    _same_tree(_np(tj), tt)
    assert et == pytest.approx(float(ej), rel=0, abs=0)
    assert tt["sh_rqt"]["m"].shape == (128,)
    s = np.clip(np.round(x / 0.05), -128, 127).astype(np.int8)
    jcache = jb.init_cache(2, 32, JRep.ID)
    want, _ = jb.apply_id(jax.tree.map(jnp.asarray, tj), jnp.asarray(s),
                          cache=jcache, pos=0)
    lm = DecoderLM(dataclasses.replace(get_config(ARCH).reduced(),
                                       n_layers=2), max_seq=64)
    caches = lm.init_caches(2, 32, device="cpu")
    cache = {"k": caches["k"][1], "v": caches["v"][1],
             "table": caches["table"], "contiguous": True}
    got = tb.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(s), cache,
                      torch.zeros(2, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sh_rqt_schedules_where_the_reference_does_at_full_width():
    """`sh_rqt` at d_ff 8192: 400 log-uniform ratios in [0.05, 20]; the
    same ones schedule (equal tables) and the rest raise the same
    ValueError in both packages."""
    d_ff = get_config(ARCH).d_ff
    kw = dict(zp_out=0, qmin=-SHARED_RANGE, qmax=SHARED_RANGE,
              requant_factor=256, acc_bound=d_ff * 127.0 * 127.0)
    ratios = np.exp(np.random.default_rng(0).uniform(
        np.log(0.05), np.log(20.0), 400))
    ok = 0
    for r in ratios:
        eps_out = 1e-3
        eps_in = np.full(4, r * eps_out)
        try:
            want = j_make_rqt(eps_in, eps_out, **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                make_rqt(eps_in, eps_out, **kw)
            assert str(got.value) == str(e)
            assert "unschedulable in int32" in str(e)
            continue
        _same_tree(_np(want), make_rqt(eps_in, eps_out, **kw))
        ok += 1
    print(f"sh_rqt at d_ff {d_ff}: {ok} of 400 ratios schedule")
    assert 0 < ok < 400


# -- the whole reduced model -------------------------------------------------
@pytest.fixture(scope="module")
def model():
    """The reference's lm, params (PRNGKey(0)), its calibrator on the 4 x
    32 sample and deploy; the port's lm and calibrator on the same."""
    cfg = j_get_config(ARCH).reduced()
    jlm = JLM(cfg, max_seq=MAX_LEN)
    p = jlm.init(jax.random.PRNGKey(0))
    sample = _sample(*SAMPLE)
    jc = jlm.calibrate(p, jnp.asarray(sample))
    jt = jlm.deploy(p, jc)
    tlm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    tc = tlm.calibrate(_np(p), sample, device="cpu")
    return jlm, p, jc, jt, tlm, tc, sample


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(np.shape(tree))}


def test_registered_plan_and_trees_equal_reference(model):
    jlm, p, _, _, tlm, _, _ = model
    assert ARCH in LM_ARCH_IDS and ARCH in SERVE_ARCH_IDS
    assert [(k, n) for k, _, n in tlm.plan()] == [
        (k, n) for k, _, n in jlm.plan()] == [("pair", 1)]
    assert [tlm.layer_scope(i) for i in range(2)] == ["S0.L0.a.",
                                                      "S0.L0.b."]
    assert tlm.pair and tlm.n_kv_layers == 2
    assert _paths(tlm.init_np(0)) == _paths(_np(p))
    assert _paths(tlm.init_qstate("cpu")) == _paths(_np(jlm.init_qstate()))
    j, t = j_get_config(ARCH), get_config(ARCH)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for f in dataclasses.fields(t):
        if f.name != "notes":
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_fp_logits_and_calibration_equal_reference(model):
    jlm, p, jc, _, tlm, tc, sample = model
    want = jlm.logits(p, jlm.apply(p, jlm.embed_in(
        p, jnp.asarray(sample), JRep.FP), JRep.FP)[0], JRep.FP)
    tp = params_to_torch(_np(p), "cpu")
    got = tlm.logits(tp, tlm.apply(tp, tlm.embed_in(
        tp, torch.from_numpy(sample))))
    _close(want, got.numpy(), TOL)
    assert sum(".b.sh.shared_mlp." in n for n in jc.hi) == 4
    _span_close(jc, tc)


def test_deploy_equals_reference_and_raises_where_it_raises(model):
    jlm, p, jc, jt, tlm, tc, _ = model
    ref = _np(jt)
    assert _deploy_diff(ref, tlm.deploy(_np(p), jc)) == []
    off = _deploy_diff(ref, tlm.deploy(_np(p), tc))
    print(f"requant multipliers on a calibration boundary: {off}")
    assert len(off) <= 4
    # the 2 x 16 sample: sh_rqt unschedulable in both
    small = _sample(2, 16)
    with pytest.raises(ValueError, match="unschedulable") as want:
        jlm.deploy(p, jlm.calibrate(p, jnp.asarray(small)))
    with pytest.raises(ValueError) as got:
        tlm.deploy(_np(p), tlm.calibrate(_np(p), small, device="cpu"))
    assert str(got.value).split("(")[0] == str(want.value).split("(")[0]


def test_deploy_model_raises_where_the_reference_raises(model):
    """max_seq 32 / 64: the entry point's 4 x 31 / 4 x 63 sample does not
    divide into MoE groups of 64 (AssertionError there, ValueError
    here); max_seq 128: the reference's sh_rqt is unschedulable from
    its 4 x 64 sample, the port's deploy of the same params from the
    same sample raises the same, and the port's `deploy_model` (its own
    seeded params) raises there too."""
    for m in (32, 64):
        with pytest.raises(AssertionError):
            j_deploy_model(ARCH, reduced=True, max_seq=m)
        with pytest.raises(ValueError, match=", 64\\)"):
            deploy_model(ARCH, reduced=True, max_seq=m, device="cpu")
    with pytest.raises(ValueError, match="unschedulable") as want:
        j_deploy_model(ARCH, reduced=True, max_seq=128)
    jlm, p, _, _, tlm, _, _ = model
    from repro_torch.launch.serve import calibration_sample

    sample = calibration_sample(tlm.cfg.vocab, 128)
    assert sample.shape == (4, 64)
    with pytest.raises(ValueError) as got:
        tlm.deploy(_np(p), tlm.calibrate(_np(p), sample, device="cpu"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unschedulable"):
        deploy_model(ARCH, reduced=True, max_seq=128, device="cpu")


def test_prefill_and_decode_equal_reference(model):
    jlm, _, _, jt, tlm, _, _ = model
    tt = tables_from_numpy(_np(jt), device="cpu")
    assert len(tt["layers"]) == 2 and "sh_rqt" in tt["layers"][1]
    assert "moe" not in tt["layers"][0]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, size=(2, 32)).astype(np.int32)
    jcache = jlm.init_caches(2, 40, JRep.ID)
    wl, jcache = jlm.prefill(jt, jnp.asarray(prompt), jcache)
    caches = tlm.init_caches(2, 40, device="cpu")
    gl = tlm.prefill(tt, torch.from_numpy(prompt.copy()), caches)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    tok = np.asarray(jnp.argmax(wl[:, -1], axis=-1), np.int32)[:, None]
    for i in range(3):
        pos = np.full((2,), 32 + i, np.int32)
        wl, jcache = jlm.decode_step(jt, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos))
        gl = tlm.decode_step(tt, torch.from_numpy(tok.copy()), caches,
                             torch.from_numpy(pos))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        tok = np.asarray(jnp.argmax(wl[:, 0], axis=-1), np.int32)[:, None]
    # the pools hold the reference's (n, 2, B, K, T, hd) rows, pair-major
    ref_k = np.asarray(jcache[0]["k"])
    for i in range(2):
        np.testing.assert_array_equal(caches["k"][i, 1:].numpy(),
                                      ref_k[0, i])


# -- the engine --------------------------------------------------------------
# (prompt length, new tokens): three lengths, so that the reference's
# exact-mode prefill compiles three times; 64 is one whole MoE group
WORK = [(5, 6), (17, 5), (64, 6), (17, 4), (5, 6), (64, 5), (17, 6),
        (5, 3)]


def _state(a):
    s = {"owner": list(a.owner), "lengths": a.lengths.tolist(),
         "n_free": a.n_free}
    if hasattr(a, "page_table"):
        s["page_table"] = a.page_table.tolist()
    return s


@pytest.mark.parametrize("paged,depth", [(False, 0), (True, 0),
                                         (True, 1)])
def test_engine_tokens_equal_reference(model, paged, depth):
    jlm, _, _, jt, tlm, _, _ = model
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_depth=depth)
    if paged:
        kw.update(paged=True, page_size=8)
    j = JServingEngine(jlm, jt, JServingConfig(
        paged_kernel=False if paged else None,
        scheduler=JSchedulerConfig(), **kw))
    t = ServingEngine(tlm, tables_from_numpy(_np(jt), device="cpu"),
                      ServingConfig(device="cpu", scheduler=SchedulerConfig(),
                                    **kw))
    assert t._prefill_mode == j._prefill_mode == "exact"
    rng = np.random.default_rng(7)
    work = [(rng.integers(0, 256, size=(n,)), g) for n, g in WORK]

    def step():
        assert j.step() == t.step()
        assert _state(t.arena) == _state(j.arena)

    for prompt, g in work:
        for eng in (j, t):
            eng.submit(copy.deepcopy(prompt), max_new_tokens=g)
        step()
    n = 0
    while j.active or j.queue.pending or t.active or t.queue.pending:
        step()
        n += 1
        assert n < 200
    got = [[(c.req_id, list(map(int, c.tokens)), c.finish_reason)
            for c in eng.completed] for eng in (j, t)]
    assert got[1] == got[0]
    assert sorted(len(toks) for _, toks, _ in got[1]) == sorted(
        g for _, g in WORK)
    assert t.stats()["steps"] == j.stats()["steps"]


def test_engine_kv4_refused_as_the_reference_refuses(model):
    """The MoE family prefills at exact length, which kv_bits 4 does not
    take: both engines refuse it alike (its pools are held through
    `prefill_chunk` below)."""
    jlm, _, _, jt, tlm, _, _ = model
    kw = dict(n_slots=3, max_len=MAX_LEN, paged=True, page_size=8,
              kv_bits=4)
    with pytest.raises(ValueError) as want:
        JServingEngine(jlm, jt, JServingConfig(paged_kernel=False, **kw))
    with pytest.raises(ValueError) as got:
        ServingEngine(tlm, tables_from_numpy(_np(jt), device="cpu"),
                      ServingConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("C", [1, 6])
def test_prefill_chunk_over_pair_pools_equals_reference(model, kv_bits, C):
    """One unified dispatch over stale pools (int8, or int4-packed) of
    both blocks of the pair through a page table (a parked row, PAGE_NULL
    holes), the reference on its gather path: int32 logits and every
    pool byte for byte, the reference's (n, 2, ...) pools read pair-major
    as the port's per-block pools."""
    from repro.launch import variants as j_variants
    from repro.layers.attention import INACTIVE_POS

    jlm, _, _, jt, tlm, _, _ = model
    cfg, PS = tlm.cfg, 8
    B, pps, n_pages = 5, MAX_LEN // PS, 84
    rng = np.random.default_rng(40 + C + kv_bits)
    hd = cfg.hd // (8 // kv_bits)
    shape = (cfg.n_layers, n_pages + 1, cfg.n_kv_heads, PS, hd)
    k = rng.integers(-128, 128, size=shape).astype(np.int8)
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    table = rng.permutation(np.arange(1, n_pages + 1))[:B * pps].reshape(
        B, pps).astype(np.int32)
    table[2, 2:] = 0
    table[4] = 0
    pos = np.array([3, 5, 8, 31 - C, INACTIVE_POS], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, C)).astype(np.int32)
    last = rng.integers(0, C, size=B).astype(np.int32)

    def pairs(a):
        return jnp.asarray(a.reshape((1, 2) + a.shape[1:]))

    j_caches = [{"k": pairs(k), "v": pairs(v),
                 "table": jnp.broadcast_to(jnp.asarray(table),
                                           (1, 2) + table.shape)}]
    with j_variants.use_variants(paged_decode="gather"):
        want, j_new = jax.jit(jlm.prefill_chunk)(
            jt, jnp.asarray(toks), j_caches, jnp.asarray(pos),
            jnp.asarray(last))
    t_caches = {"k": torch.from_numpy(k.copy()),
                "v": torch.from_numpy(v.copy()),
                "table": torch.from_numpy(table)}
    got = tlm.prefill_chunk(tables_from_numpy(_np(jt), device="cpu"),
                            torch.from_numpy(toks), t_caches,
                            torch.from_numpy(pos), torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kv in ("k", "v"):
        np.testing.assert_array_equal(
            t_caches[kv].numpy(),
            np.asarray(j_new[0][kv]).reshape(shape))


# -- FQ training -------------------------------------------------------------
def test_fq_train_step_within_the_reference_gap():
    """One FQ value-and-gradient of the trainer's initial state on its
    first batch (2 x 32 tokens, one MoE group): the port within 1.5x the
    reference's own jit-vs-op-by-op gap, the loss and every leaf (the
    shared MLP's weights and clips included)."""
    jlm, jtr, _, _, stream = j_build(ARCH, reduced=True, seq=32, batch=2)
    lm, _, _, _, _ = build(ARCH, reduced=True, seq=32, batch=2,
                           device="cpu")
    tok = stream.batch(0)

    def jloss(t):
        return jlm.loss_fn(t["params"], t["qstate"], jnp.asarray(tok),
                           JRep.FQ)

    jit = jax.jit(jax.value_and_grad(jloss))(jtr)
    with jax.disable_jit():
        eager = jax.value_and_grad(jloss)(jtr)
    port = value_and_grad(
        lambda t, x: lm.loss_fn(t["params"], t["qstate"], x, Rep.FQ),
        params_to_torch(_np(jtr), "cpu"), torch.from_numpy(np.array(tok)))
    assert "mlp" in jtr["qstate"]["segments"][0]["b"]
    check_against_both_runs(jit, eager, port)
