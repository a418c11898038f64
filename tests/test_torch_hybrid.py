"""The hybrid family (zamba2_1_2b) in the port against the JAX
reference, on the reduced config (7 layers: 3 groups of 2 Mamba-2
blocks, each followed by the shared attention over concat(x, x0), then
a 1-block tail).

Held at tolerance 0 unless stated:

  - the Mamba-2 island's new fixed float32 sequences against XLA's
    lowering under `jax.jit`, bit for bit on sweeps and edges:
    `rsqrt_f32`, `window_sum` (the mean's reduction at d_inner 256 and
    4096), `lane8_dot` (the batched contraction of h with C) and the
    gate z / (1 + e^-z);
  - `QMamba2.apply_id` against the reference's jitted one at L 1-256
    with and without a state: out_proj's int32 accumulator, the conv
    window, h bit for bit, and the s_n images that differ (0);
  - the calibration within 1e-5 of the span; the deploy leaf for leaf
    (every per-application `sh` table) from the reference's ranges, and
    from the port's own with every difference counted;
  - the float forward within 1e-5 of max |ref|;
  - a prefill then decode steps of the whole model (logits, conv, h,
    the shared pools), `serve_batch`, the engine in exact mode over
    `SlotArena` and the paged arena at depth 0 and 1 and under a
    scripted preemption, and one prompt of 4097 tokens, whose shared
    attention streams (the blockwise path) on both sides;
  - the config and param_count, the refusals, the CLI.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.rep import Rep
from repro.launch.serve import serve_batch as j_serve_batch
from repro.layers.ssm import QMamba2 as JQMamba2
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.core.island import (
    exp_f32, lane8_dot, rsqrt_f32, window_sum,
)
from repro_torch.launch.serve import (
    calibration_sample, deploy_model, main as serve_main, serve_batch,
)
from repro_torch.kernels.requant_kernel import requant, requant_act
from repro_torch.layers.ssm import QMamba2, causal_conv1d_int
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy, tree_to_torch,
)
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine, SlotArena,
)
from repro_torch.serving.cache import assert_integer_caches
from test_policy import ScriptedPreemptions
from test_torch_moe import _deploy_diff

TOL = 1e-5
ARCH = "zamba2_1_2b"
MAX_LEN = 64
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The island is thousands of small torch ops; beside the suite's
    other workers intra-op threads only contend for the cores, so this
    module runs torch on one thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits_differ(a, b) -> int:
    a = np.ascontiguousarray(np.asarray(a, F32))
    b = np.ascontiguousarray(np.asarray(b, F32))
    assert a.shape == b.shape
    return int((a.view(np.int32) != b.view(np.int32)).sum())


# -- the island functions --------------------------------------------------
def test_rsqrt_equals_the_lowered_rsqrt():
    """1 / sqrt as XLA lowers it on an AVX host (not always the nearest
    float32) on a sweep of 2^-40..2^40 and the edges of its table,
    vectorized and scalar."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.exp(rng.uniform(-28, 28, 400_000)),
                        rng.uniform(1e-6, 4.0, 200_000),
                        [1e-6, 1.0, 2.0, 4.0, 0.25, 1.0009766, 3.9999998]])
    x = x.astype(F32)
    for xs in (x, x[:1].reshape(1, 1), x[:30].reshape(1, 30)):
        want = jax.jit(jax.lax.rsqrt)(xs)
        assert _bits_differ(rsqrt_f32(torch.from_numpy(xs)).numpy(),
                            want) == 0


@pytest.mark.parametrize("d", [256, 4096])
def test_mean_of_squares_equals_reference(d):
    """The gated norm's mean over d_inner: squares, XLA's windowed sum,
    times 1/d, plus 1e-6, rsqrt."""
    rng = np.random.default_rng(d)
    g = (rng.standard_normal((3, 5, d))
         * np.exp(rng.standard_normal((3, 5, d)) * 2)).astype(F32)

    def ref(g):
        var = jnp.mean(g * g, axis=-1, keepdims=True)
        return var, jax.lax.rsqrt(var + 1e-6)

    jv, jr = jax.jit(ref)(g)
    gt = torch.from_numpy(g)
    var = window_sum(gt * gt) * (1.0 / d)
    assert _bits_differ(var.numpy(), np.asarray(jv)[..., 0]) == 0
    assert _bits_differ(rsqrt_f32(var + 1e-6).numpy(),
                        np.asarray(jr)[..., 0]) == 0


@pytest.mark.parametrize("L,H,P,n", [(30, 8, 32, 16), (3, 64, 64, 64),
                                     (1, 64, 64, 64)])
def test_lane8_dot_equals_the_batched_contraction(L, H, P, n):
    """einsum("blhpn,blhn->blhp") as XLA runs the batched
    matrix-vector product, at reduced and full Mamba-2 width."""
    rng = np.random.default_rng(n + L)
    h = (rng.standard_normal((1, L, H, P, n))
         * np.exp(rng.standard_normal((1, L, H, P, n)) * 3)).astype(F32)
    c = (rng.standard_normal((1, L, H, n))
         * np.exp(rng.standard_normal((1, L, H, n)))).astype(F32)
    want = jax.jit(lambda a, b: jnp.einsum("blhpn,blhn->blhp", a, b))(h, c)
    got = lane8_dot(torch.from_numpy(h), torch.from_numpy(c)[..., None, :])
    assert _bits_differ(got.numpy(), want) == 0


def test_gate_equals_reference():
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.standard_normal(100_000) * 6,
                        rng.uniform(-120, 120, 50_000),
                        [0.0, -0.0, 88.0, -88.0, 104.0]]).astype(F32)
    want = jax.jit(lambda z: z / (1.0 + jnp.exp(-z)))(z)
    zt = torch.from_numpy(z)
    assert _bits_differ((zt / (1.0 + exp_f32(-zt))).numpy(), want) == 0


# -- the model ---------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The port's seeded params (`init_np`, in the reference's hybrid
    layout, shared by both sides), both packages' calibrations of them
    on the entry point's sample, the reference's lm and deploy, and the
    port's lm and the tables carried across."""
    tlm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    p = tlm.init_np(0)
    jlm = JLM(j_get_config(ARCH).reduced(), max_seq=MAX_LEN)
    sample = calibration_sample(tlm.cfg.vocab, MAX_LEN)
    jp = jax.tree.map(jnp.asarray, p)
    jc = jlm.calibrate(jp, jnp.asarray(sample))
    jt = jlm.deploy(jp, jc)
    tc = tlm.calibrate(p, sample, device="cpu")
    return dict(jlm=jlm, p=p, jc=jc, jt=jt, tlm=tlm, tc=tc,
                tt=tables_from_numpy(_np(jt), device="cpu"))


def test_plan_and_scopes_equal_reference(ref):
    jlm, tlm = ref["jlm"], ref["tlm"]
    assert [(k, n) for k, _, n in tlm.plan()] == [
        (k, n) for k, _, n in jlm.plan()] == [("hybrid", 3), ("mamba", 1)]
    assert tlm.steps() == [
        ("layer", 0), ("layer", 1), ("shared", 0), ("layer", 2),
        ("layer", 3), ("shared", 1), ("layer", 4), ("layer", 5),
        ("shared", 2), ("layer", 6)]
    assert [tlm.layer_scope(i) for i in (0, 1, 5, 6)] == [
        "S0.L0.m0.", "S0.L0.m1.", "S0.L2.m1.", "S1.L0."]
    assert tlm.n_kv_layers == 3 and tlm.recurrent and tlm.has_kv


def test_calibrate_equals_reference(ref):
    jc, tc = ref["jc"], ref["tc"]
    assert list(tc.hi) == list(jc.hi)
    assert sum(".sh." in n for n in jc.hi) > 0
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n


def _split_sm_tabs(tree):
    """-> (tree without the shared applications' sm_tabs, those)."""
    tree = copy.deepcopy(tree)
    sm = tree["segments"][0]["sh"]["attn"].pop("sm_tabs")
    return tree, sm


def test_deploy_equals_reference_leaf_for_leaf(ref):
    """From the reference's ranges every table equals the reference's,
    the per-application shared tables included.  From the port's own
    ranges (within 7e-7 of the span) a requant multiplier on a float64
    boundary may move by one, and the integer softmax's exp LUT by one
    where round(e^r 2^14) sits on a half-integer: counted."""
    want = _np(ref["jt"])
    sh = want["segments"][0]["sh"]
    assert set(sh) == {"cat_rqt_x", "cat_rqt_x0", "norm", "attn", "add"}
    assert sh["attn"]["wq"]["w_q"].shape == (3, 256, 128)  # 3 applications
    assert set(want["segments"][0]["m"]["core"]) == {
        "in_proj", "p_rqt", "conv_wq", "conv_bq", "conv_rqt", "conv_lut",
        "A", "Dv", "dt_bias", "eps_p_f", "eps_conv_f", "zp_conv_f",
        "norm_g_f", "eps_n_inv", "out_proj"}
    assert _deploy_diff(want, ref["tlm"].deploy(_np(ref["p"]),
                                                ref["jc"])) == []
    own = ref["tlm"].deploy(_np(ref["p"]), ref["tc"])
    w, w_sm = _split_sm_tabs(want)
    o, o_sm = _split_sm_tabs(own)
    off = _deploy_diff(w, o)
    lut = np.abs(w_sm["exp_lut"].astype(np.int64) - o_sm["exp_lut"])
    assert int(lut.max()) <= 1
    for k in ("m_ln2", "d_ln2", "ln2_img", "r_step"):
        np.testing.assert_array_equal(o_sm[k], w_sm[k], err_msg=k)
    print(f"own calibration: multipliers moved {off}, exp LUT entries "
          f"moved {int((lut != 0).sum())} of {lut.size}")
    assert len(off) <= 4 and int((lut != 0).sum()) <= 8


def test_float_forward_equals_reference(ref):
    """The whole float forward (embed, the groups with x0, the tail,
    the final norm and head) within TOL of max |ref|."""
    jlm, tlm, p = ref["jlm"], ref["tlm"], ref["p"]
    toks = np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32)

    def jfwd(p, toks):
        x = jlm.embed_in(p, toks, Rep.FP)
        x, _, _ = jlm.apply(p, x, Rep.FP)
        return jlm.logits(p, x, Rep.FP)

    want = np.asarray(jax.jit(jfwd)(jax.tree.map(jnp.asarray, p), toks))
    pt = params_to_torch(p, "cpu")
    x = tlm.embed_in(pt, torch.from_numpy(toks))
    got = tlm.logits(pt, tlm.apply(pt, x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("L,cached", [(1, True), (30, True), (30, False),
                                      (128, True), (256, False)])
def test_qmamba2_apply_id_equals_reference(ref, L, cached):
    """Group 0's first Mamba-2 core, the reference's `apply_id` jitted:
    out_proj's int32 accumulator, the conv window, h bit for bit (the
    s_n images are counted below)."""
    t_np = jax.tree.map(lambda a: a[0][0], _np(ref["jt"])["segments"][0]["m"])
    jm = JQMamba2(128, d_state=16, expand=2, head_dim=32)
    tm = QMamba2(128, d_state=16, expand=2, head_dim=32)
    tt = tree_to_torch(t_np["core"], "cpu")
    rng = np.random.default_rng(L)
    s_x = rng.integers(-128, 128, (2, L, 128)).astype(np.int8)
    cache = None
    if cached:
        cache = {"conv": rng.integers(-128, 128, (2, 3, tm.d_conv_in)
                                      ).astype(np.int8),
                 "h": (rng.standard_normal((2, 8, 32, 16)) * 0.1).astype(F32)}
    jo, jc = jax.jit(lambda t, s, c: jm.apply_id(t, s, cache=c))(
        t_np["core"], s_x, cache)
    tcache = (None if cache is None
              else {k: torch.from_numpy(v) for k, v in cache.items()})
    to, tc = tm.apply_id(tt, torch.from_numpy(s_x), tcache)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if cached:
        np.testing.assert_array_equal(tc["conv"].numpy(),
                                      np.asarray(jc["conv"]))
        assert _bits_differ(tc["h"].numpy(), jc["h"]) == 0


def test_s_n_images_equal_reference(ref):
    """The island's int8 exit image s_n (out_proj's input): the port's
    `island` against the reference's traced value, group 1's first
    core at L 30 with a state: 0 images differ."""
    import repro.layers.ssm as jssm

    core = jax.tree.map(lambda a: a[1][0],
                        _np(ref["jt"])["segments"][0]["m"])["core"]
    jm = JQMamba2(128, d_state=16, expand=2, head_dim=32)
    tm = QMamba2(128, d_state=16, expand=2, head_dim=32)
    rng = np.random.default_rng(11)
    s_x = rng.integers(-128, 128, (2, 30, 128)).astype(np.int8)
    conv = rng.integers(-128, 128, (2, 3, tm.d_conv_in)).astype(np.int8)
    h0 = (rng.standard_normal((2, 8, 32, 16)) * 0.1).astype(F32)
    seen = {}
    orig = jssm.QLinear.apply_id

    def spy(self, ip, s):
        if s.shape[-1] == tm.d_inner:
            seen["s_n"] = s
        return orig(self, ip, s)

    jssm.QLinear.apply_id = spy
    try:
        _, want = jax.jit(lambda t, s, c: (
            jm.apply_id(t, s, cache=c)[0], seen["s_n"]))(
                core, s_x, {"conv": conv, "h": h0})
    finally:
        jssm.QLinear.apply_id = orig
    tt = tree_to_torch(core, "cpu")
    s_all = tm._sub()["in_proj"].apply_id(tt["in_proj"],
                                          torch.from_numpy(s_x), tt["p_rqt"])
    s_z, s_xbc, s_dt = tm._split_proj(s_all)
    c_acc = causal_conv1d_int(torch.cat([torch.from_numpy(conv), s_xbc], 1),
                              tt["conv_wq"], tt["conv_bq"])
    s_conv = requant_act(requant(c_acc, tt["conv_rqt"]),
                         {"lut": tt["conv_lut"]})
    got, _ = tm.island(tt, s_z, s_conv, s_dt, torch.from_numpy(h0))
    n = int((got.numpy() != np.asarray(want)).sum())
    print(f"s_n images that differ: {n} of {got.numel()}")
    assert n == 0


def _cache_equal(jcaches, tc, pools=True):
    """The port's cache tree against the reference's hybrid one: every
    Mamba block's conv window and h state (h bit for bit; the groups'
    blocks in order, then the tail) and, with `pools`, the shared K/V
    (the port's slot pages 1.. against the reference's rows)."""
    jm = _np(jcaches[0]["m"])
    G, k = jm["h"].shape[:2]
    for key in ("conv", "h"):
        want = np.concatenate([jm[key].reshape(G * k, *jm[key].shape[2:])]
                              + [_np(seg[key]) for seg in jcaches[1:]])
        got = tc[key].numpy()
        if key == "h":
            assert _bits_differ(got, want) == 0
        else:
            np.testing.assert_array_equal(got, want)
    if pools:
        for kv in ("k", "v"):
            want = _np(jcaches[0]["sh"][kv])
            np.testing.assert_array_equal(
                tc[kv][:, 1:want.shape[1] + 1].numpy(), want, err_msg=kv)


@pytest.mark.parametrize("L", [128])
def test_prefill_then_decode_equals_reference(ref, L):
    """The whole model (reference: its jitted `prefill` and
    `decode_step` over `init_caches`): a prefill of L tokens on the
    chunked path (the engine tests below take one scan block), then
    three decode steps: int32 logits, the conv state, h bit for bit and
    the shared KV."""
    jlm, jt, tlm, tt = ref["jlm"], ref["jt"], ref["tlm"], ref["tt"]
    max_len = 160
    jlm = JLM(jlm.cfg, max_seq=max_len)
    tlm = DecoderLM(tlm.cfg, max_seq=max_len)
    toks = np.random.default_rng(L).integers(0, 256, (2, L)).astype(np.int32)
    jc = jlm.init_caches(2, max_len, Rep.ID)
    jl, jc = jax.jit(jlm.prefill)(jt, toks, jc)
    tc = tlm.init_caches(2, max_len, device="cpu")
    tl = tlm.prefill(tt, torch.from_numpy(toks), tc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    dec = jax.jit(jlm.decode_step)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(
            np.int32)[:, None]
        pos = np.full((2,), L + i, np.int32)
        jl, jc = dec(jt, nxt, jc, pos)
        tl = tlm.decode_step(tt, torch.from_numpy(nxt), tc,
                             torch.from_numpy(pos))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _cache_equal(jc, tc)


def test_serve_batch_equals_reference(ref):
    jlm, jt, tlm, tt = ref["jlm"], ref["jt"], ref["tlm"], ref["tt"]
    prompts = np.random.default_rng(5).integers(
        0, 256, (3, 12)).astype(np.int32)
    want = np.asarray(j_serve_batch(jlm, jt, jnp.asarray(prompts), 5))
    np.testing.assert_array_equal(
        serve_batch(tlm, tt, prompts, 5).numpy(), want)


# -- the engine ---------------------------------------------------------------
# two prompt lengths, since the reference compiles a prefill per length
WORK = [(9, 6), (1, 5), (9, 4), (9, 3)]
WORK_PREEMPT = [(9, 6), (9, 5), (1, 6), (9, 4)]


def _engines(ref, *, paged, depth=0, policy=None, max_len=MAX_LEN,
             lms=None):
    kw = dict(n_slots=2, max_len=max_len, dispatch_depth=depth)
    if paged:
        kw.update(paged=True, page_size=8)
    jlm, tlm = lms or (ref["jlm"], ref["tlm"])
    j = JServingEngine(jlm, ref["jt"], JServingConfig(
        policy=policy() if policy else None,
        paged_kernel=False if paged else None,
        scheduler=JSchedulerConfig(), **kw))
    t = ServingEngine(tlm, ref["tt"], ServingConfig(
        device="cpu", policy=policy() if policy else None,
        scheduler=SchedulerConfig(), **kw))
    return j, t


def _state(a):
    s = {"owner": list(a.owner), "lengths": a.lengths.tolist(),
         "n_free": a.n_free}
    if hasattr(a, "page_table"):
        s.update(page_table=a.page_table.tolist(),
                 committed=a.committed_pages, free_pages=a.free_pages)
    return s


def _step_both(j, t):
    out = []
    for eng in (j, t):
        try:
            out.append(eng.step())
        except RuntimeError as e:
            out.append(("raised", str(e)))
    assert out[0] == out[1]
    assert _state(t.arena) == _state(j.arena)
    return out[0]


def _lockstep(j, t, seed=0, work=WORK):
    rng = np.random.default_rng(seed)
    for n, g in work:
        prompt = rng.integers(0, 256, size=(n,))
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


def _arena_equal(j, t):
    """The arenas after the drain: the state, and over `SlotArena` the
    shared pools."""
    _cache_equal(j.arena.caches, t.arena.caches,
                 pools=isinstance(t.arena, SlotArena))


@pytest.mark.parametrize("paged,depth", [(False, 0), (True, 1)])
def test_tokens_equal_reference_in_exact_mode(ref, paged, depth):
    j, t = _engines(ref, paged=paged, depth=depth)
    assert t._prefill_mode == j._prefill_mode == "exact"
    assert isinstance(t.arena, SlotArena) != paged
    res = _lockstep(j, t)
    assert res[1] == res[0]
    assert t.stats()["steps"] == j.stats()["steps"]
    _arena_equal(j, t)


def test_scripted_preemption_as_the_reference(ref):
    """A decode evicted mid-generation over the paged arena re-prefills
    prompt + tokens[:-1] from a zero state: the port raises where the
    reference's resume oracle raises, else both finish alike."""
    j, t = _engines(ref, paged=True,
                    policy=lambda: ScriptedPreemptions({3: "active"}))
    res = _lockstep(j, t, seed=1, work=WORK_PREEMPT)
    if isinstance(res, tuple):
        assert "resume parity violated" in res[1]
        return
    assert res[1] == res[0]
    assert t.stats()["n_preempts"] == j.stats()["n_preempts"] > 0
    _arena_equal(j, t)


def test_a_4097_token_prompt_streams_in_the_shared_attention(ref):
    """One exact-mode prompt of 4097 tokens over SlotArena at max_len
    6144, on the first group of the reduced model (2 Mamba-2 blocks and
    one shared application; the groups repeat, and a cut keeps the
    test's time): the scratch prefill's shared attention takes the
    blockwise path on both sides; tokens and the arena equal."""
    import dataclasses

    cfg = dataclasses.replace(ref["tlm"].cfg, n_layers=2)
    jcfg = dataclasses.replace(ref["jlm"].cfg, n_layers=2)
    jt = dict(ref["jt"], segments=[jax.tree.map(
        lambda a: a[:1], ref["jt"]["segments"][0])])
    cut = dict(ref, jt=jt, tt=tables_from_numpy(_np(jt), device="cpu"))
    lms = (JLM(jcfg, max_seq=6144), DecoderLM(cfg, max_seq=6144))
    j, t = _engines(cut, paged=False, max_len=6144, lms=lms)
    res = _lockstep(j, t, seed=2, work=[(4097, 2)])
    assert res[1] == res[0]
    _arena_equal(j, t)


def test_serving_refusals_and_integer_caches_as_the_reference(ref):
    for kw in (dict(kv_bits=4), dict(prefix_cache=True)):
        msgs = []
        for make in (
                lambda: JServingEngine(ref["jlm"], ref["jt"], JServingConfig(
                    n_slots=2, max_len=64, paged=True, **kw)),
                lambda: ServingEngine(ref["tlm"], ref["tt"], ServingConfig(
                    n_slots=2, max_len=64, paged=True, device="cpu", **kw))):
            with pytest.raises(ValueError) as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "'exact' mode" in msgs[0]
    t = _engines(ref, paged=True)[1]
    assert_integer_caches(t.arena.caches, allow_ssm_state=True)
    with pytest.raises(AssertionError, match="'h'"):
        assert_integer_caches(t.arena.caches)
    assert set(t.arena.caches) == {"conv", "h", "k", "v"}
    assert t.arena.caches["k"].shape[0] == 3


def test_layer_by_layer_deploy_model_equals_whole_tree():
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
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path

    eq(whole, streamed)
    assert len(whole["shared"]) == 3 and len(whole["layers"]) == 7


def test_cli_serves_zamba2(capsys):
    serve_main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--prompt-len", "12",
                "--gen", "3", "--max-len", "64", "--ragged"])
    out = capsys.readouterr().out
    assert "tok/s" in out or "throughput" in out


def test_config_param_count_and_depth_cut():
    """The config and its parameter count are the reference's; an
    n_layers cut keeps shared_attn_every, so 14 layers are 2 groups and
    a 2-block tail."""
    import dataclasses

    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()
    lm = DecoderLM(dataclasses.replace(cfg, n_layers=14))
    assert [(k, n) for k, _, n in lm.plan()] == [("hybrid", 2), ("mamba", 2)]
    assert lm.n_kv_layers == 2
