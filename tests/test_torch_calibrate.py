"""The port's FullPrecision forward and calibration against the JAX
reference's.

Calibration is the step from the float model to its integer tables
(the paper's §2.2): the float forward runs a sample and a `Calibrator`
records each activation's range, which `deploy` reads.  Here, on the
same inputs (made with numpy from a seed) and the reference's own
params carried across as numpy:

* each float-forward module (the activations, the embedding, RMSNorm,
  Linear, float RoPE, attention, Add, the gated MLP, the dense block,
  the LM's embed_in / apply / logits) equals the reference's within
  1e-5 of max |ref| (torch's and XLA's float32 matmuls, exp and softmax
  round differently in the last ulp), and observes the same names,
  each lo / hi within 1e-5 of the reference's span;
* the `Calibrator` (observe at momentum 1 and below 1, merge, beta,
  range, state round trip) equals the reference's at tolerance 0;
* `SyntheticStream` batches are equal;
* `DecoderLM.calibrate` records the reference's names in its order,
  each range within 1e-5 of the span, on reduced granite_3_2b,
  llama3_2_3b and chatglm3_6b;
* the deploy from the port's own calibrator equals the reference's
  deploy from its own: integer leaves equal (an entry may differ by
  one only where the calibrator entries behind its leaf are within
  the tolerance above, i.e. its rounding sits on a boundary, and the
  test names them), float leaves within rtol 1e-5;
* the port's calibrate -> deploy -> `ServingEngine` gives the tokens of
  the reference's `deploy_model` -> `ServingEngine(paged=True,
  paged_kernel=False)` on the three reduced configs at kv_bits 8 and 4.
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.rep import Rep
from repro.data.synthetic import (
    SyntheticConfig as JSyntheticConfig, SyntheticStream as JSyntheticStream,
)
from repro.launch.serve import deploy_model as j_deploy_model
from repro.layers.add import QAdd as JQAdd
from repro.layers.attention import QAttention as JQAttention
from repro.layers.common import ActKind as JActKind, act_fn as j_act_fn
from repro.layers.embedding import QEmbed as JQEmbed
from repro.layers.linear import QLinear as JQLinear
from repro.layers.mlp import QMLP as JQMLP
from repro.layers.norms import QNorm as JQNorm
from repro.layers.rope import (
    apply_rope_fp as j_apply_rope_fp, rope_tables_fp as j_rope_tables_fp,
)
from repro.models.blocks import DenseBlock as JDenseBlock
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
from repro_torch.launch.serve import calibration_sample
from repro_torch.layers.add import QAdd
from repro_torch.layers.attention import QAttention
from repro_torch.layers.common import ActKind, act_fn
from repro_torch.layers.embedding import QEmbed
from repro_torch.layers.linear import QLinear
from repro_torch.layers.mlp import QMLP
from repro_torch.layers.norms import QNorm
from repro_torch.layers.rope import apply_rope_fp, rope_tables_fp
from repro_torch.models.blocks import DenseBlock
from repro_torch.models.lm import DecoderLM, params_to_torch, tables_from_numpy
from repro_torch.serving import SchedulerConfig, ServingConfig, ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5  # of max |ref| (outputs) and of the reference's span (ranges)
ARCHS = ("granite_3_2b", "llama3_2_3b", "chatglm3_6b")
MAX_LEN = 64


def _x(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ref, got, what=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.max(np.abs(ref - got)))
    assert err <= TOL * float(np.max(np.abs(ref))), (what, err)


def _same_ranges(jc: JCalibrator, tc: Calibrator):
    """Same names in the same order; each lo / hi within TOL of the
    reference's span.  -> the worst share of the span."""
    assert list(tc.hi) == list(jc.hi)
    assert list(tc.lo) == list(jc.lo)
    worst = 0.0
    for name in jc.hi:
        span = max(jc.hi[name] - jc.lo[name], 1e-6)
        d = max(abs(tc.hi[name] - jc.hi[name]),
                abs(tc.lo[name] - jc.lo[name])) / span
        assert d <= TOL, (name, d)
        worst = max(worst, d)
    return worst


# -- the float activations ----------------------------------------------
@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_act_fn_equals_reference(kind):
    x = _x(0, (4, 257), 4.0)
    _close(j_act_fn(JActKind(kind), jnp.asarray(x)),
           act_fn(ActKind(kind), torch.from_numpy(x)), kind)


# -- one module at a time ------------------------------------------------
def _embed(seed):
    j, t = JQEmbed(96, 32), QEmbed(96, 32)
    p = j.init(jax.random.PRNGKey(seed))
    tok = np.random.default_rng(seed).integers(0, 96, size=(3, 11))
    return (lambda c: j.apply_fp(p, jnp.asarray(tok), calib=c, scope="s."),
            lambda c: t.apply_fp(params_to_torch(_np(p), "cpu"),
                                 torch.from_numpy(tok), c, "s."))


def _norm(seed):
    j, t = JQNorm(48, name="norm1"), QNorm(48, name="norm1")
    g = 1.0 + 0.1 * _x(seed + 1, (48,))
    x = _x(seed, (2, 9, 48), 3.0)
    return (lambda c: j.apply_fp({"g": jnp.asarray(g)}, jnp.asarray(x),
                                 calib=c, scope="s.n1."),
            lambda c: t.apply_fp({"g": torch.from_numpy(g)},
                                 torch.from_numpy(x), c, "s.n1."))


def _linear(seed):
    j, t = JQLinear(64, 40), QLinear(64, 40)
    p = j.init(jax.random.PRNGKey(seed))
    x = _x(seed, (2, 7, 64))
    return (lambda c: j.apply_fp(p, jnp.asarray(x)),
            lambda c: t.apply_fp(params_to_torch(_np(p), "cpu"),
                                 torch.from_numpy(x)))


def _rope(base, fraction):
    def make(seed):
        x = _x(seed, (2, 3, 10, 32))
        pos = np.arange(10)

        def ref(c):
            rot, cos, sin = j_rope_tables_fp(32, 64, base, fraction)
            return j_apply_rope_fp(jnp.asarray(x), cos, sin,
                                   jnp.asarray(pos), rot)

        def got(c):
            rot, cos, sin = rope_tables_fp(32, 64, base, fraction,
                                           device="cpu")
            return apply_rope_fp(torch.from_numpy(x), cos, sin,
                                 torch.from_numpy(pos), rot)
        return ref, got
    return make


def _attention(H, K, hd, base, fraction, d=64):
    def make(seed):
        kw = dict(rope_base=base, rope_fraction=fraction, max_seq=64)
        j, t = JQAttention(d, H, K, hd, **kw), QAttention(d, H, K, hd, **kw)
        p = j.init(jax.random.PRNGKey(seed))
        x = _x(seed, (2, 13, d))
        return (lambda c: j.apply_float(p, jnp.asarray(x), Rep.FP, calib=c,
                                        scope="S0.L3.")[0],
                lambda c: t.apply_float(params_to_torch(_np(p), "cpu"),
                                        torch.from_numpy(x), c, "S0.L3."))
    return make


def _add(seed):
    a, b = _x(seed, (2, 5, 32)), _x(seed + 1, (2, 5, 32))
    return (lambda c: JQAdd(name="add1").apply_fp(
                jnp.asarray(a), jnp.asarray(b), calib=c, scope="s."),
            lambda c: QAdd(name="add1").apply_fp(
                torch.from_numpy(a), torch.from_numpy(b), c, "s."))


def _mlp(act):
    def make(seed):
        j = JQMLP(48, 96, act=JActKind(act))
        t = QMLP(48, 96, act=ActKind(act))
        p = j.init(jax.random.PRNGKey(seed))
        x = _x(seed, (2, 6, 48))
        return (lambda c: j.apply_float(p, jnp.asarray(x), Rep.FP, calib=c,
                                        scope="s."),
                lambda c: t.apply_float(params_to_torch(_np(p), "cpu"),
                                        torch.from_numpy(x), c, "s."))
    return make


def _block(seed):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              max_seq=64)
    j, t = JDenseBlock(**kw), DenseBlock(**kw)
    p = j.init(jax.random.PRNGKey(seed))
    x = _x(seed, (2, 11, 64), 0.5)
    return (lambda c: j.apply_float(p, jnp.asarray(x), Rep.FP, calib=c,
                                    scope="S0.L0.")[0],
            lambda c: t.apply_float(params_to_torch(_np(p), "cpu"),
                                    torch.from_numpy(x), c, "S0.L0."))


MODULES = {
    "embed": _embed,
    "norm": _norm,
    "linear": _linear,
    "rope": _rope(10000.0, 1.0),
    "rope_half_base_500000": _rope(500000.0, 0.5),
    "attention_gqa2": _attention(4, 2, 16, 10000.0, 1.0),
    "attention_group3_hd128": _attention(6, 2, 128, 500000.0, 1.0, d=96),
    "attention_group16_rope_half": _attention(16, 1, 16, 10000.0, 0.5),
    "add": _add,
    "mlp_silu": _mlp("silu"),
    "mlp_gelu": _mlp("gelu"),
    "block": _block,
}


@pytest.mark.parametrize("name", list(MODULES))
def test_float_module_equals_reference(name):
    ref_fn, got_fn = MODULES[name](3)
    jc, tc = JCalibrator(), Calibrator()
    want, got = ref_fn(jc), got_fn(tc)
    _close(want, got, name)
    _same_ranges(jc, tc)
    if name.startswith(("attention", "block")):
        K = {"attention_gqa2": 2, "attention_group3_hd128": 2,
             "attention_group16_rope_half": 1, "block": 2}[name]
        heads = [n for n in tc.hi if re.search(r"\.[kv]\.h\d+$", n)]
        assert len(heads) == 2 * K  # each kv head's K and V, post RoPE


# -- the calibrator ------------------------------------------------------
@pytest.mark.parametrize("momentum", [1.0, 0.3])
def test_calibrator_equals_reference_at_tolerance_0(momentum):
    rng = np.random.default_rng(7)
    arrays = [(f"n{i % 3}", (rng.standard_normal((5, 7)) * (i + 1)
                             ).astype(np.float32)) for i in range(8)]
    j, t = JCalibrator(momentum=momentum), Calibrator(momentum=momentum)
    for name, a in arrays:
        j.observe(name, jnp.asarray(a))
        t.observe(name, torch.from_numpy(a))
    assert t.state_dict() == j.state_dict()
    # a second shard, merged (new names and overlapping ones)
    j2, t2 = JCalibrator(), Calibrator()
    for name, a in arrays[:2] + [("extra", arrays[3][1] * 9)]:
        j2.observe(name, jnp.asarray(a * 2))
        t2.observe(name, torch.from_numpy(a * 2))
    j.merge(j2)
    t.merge(t2)
    assert t.state_dict() == j.state_dict()
    for name in ("n0", "n1", "extra", "missing"):
        assert t.beta(name) == j.beta(name)
        assert t.range(name) == j.range(name)
        assert t.range(name, margin=0.1) == j.range(name, margin=0.1)
    assert t.range("missing", default=(1.0, 2.0)) == (1.0, 2.0)
    assert Calibrator.from_state(j.state_dict()).state_dict() == \
        j.state_dict()


def test_calibrator_degenerate_range_and_beta_match_reference():
    j, t = JCalibrator(), Calibrator()
    zero = np.zeros((3,), np.float32)
    neg = -np.ones((3,), np.float32)
    for name, a in (("z", zero), ("neg", neg)):
        j.observe(name, jnp.asarray(a))
        t.observe(name, torch.from_numpy(a))
    for name in ("z", "neg"):
        assert t.range(name) == j.range(name)
        assert t.beta(name) == j.beta(name)


# -- the calibration sample ------------------------------------------------
@pytest.mark.parametrize("vocab,seq_len,batch,seed,n_hosts", [
    (256, 32, 4, 17, 1), (49155, 63, 4, 17, 1), (1000, 8, 6, 3, 2)])
def test_synthetic_stream_equals_reference(vocab, seq_len, batch, seed,
                                           n_hosts):
    kw = dict(vocab=vocab, seq_len=seq_len, global_batch=batch, seed=seed)
    for host in range(n_hosts):
        j = JSyntheticStream(JSyntheticConfig(**kw), host_index=host,
                             n_hosts=n_hosts)
        t = SyntheticStream(SyntheticConfig(**kw), host_index=host,
                            n_hosts=n_hosts)
        np.testing.assert_array_equal(t.successor, j.successor)
        for step in (0, 1, 5):
            a, b = j.batch(step), t.batch(step)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_calibration_sample_is_the_reference_entry_points():
    """`deploy_model`'s sample: batch 0 of 4 rows, min(64, max_seq - 1)
    tokens each, the last column dropped."""
    for max_seq in (20, 96):
        s = calibration_sample(333, max_seq)
        ref = JSyntheticStream(JSyntheticConfig(
            vocab=333, seq_len=min(64, max_seq - 1), global_batch=4)
        ).batch(0)[:, :-1]
        np.testing.assert_array_equal(s, ref)
        assert s.shape == (4, min(64, max_seq - 1))


# -- the whole model -------------------------------------------------------
_CACHE = {}


def _reference(arch):
    """(reference lm, params, its calibrator, its tables), as the
    reference's `deploy_model` builds them (PRNGKey(0), the entry
    point's sample), and the port's calibrator on the same params."""
    if arch not in _CACHE:
        cfg = j_get_config(arch).reduced()
        jlm = JLM(cfg, max_seq=MAX_LEN)
        p = jlm.init(jax.random.PRNGKey(0))
        sample = calibration_sample(cfg.vocab, MAX_LEN)
        jc = jlm.calibrate(p, jnp.asarray(sample))
        tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
        tc = tlm.calibrate(_np(p), sample, device="cpu")
        _CACHE[arch] = (jlm, p, jc, tlm, tc, sample)
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_float_forward_equals_reference(arch):
    """embed_in, apply (the eager per-layer walk) and logits (padded
    vocab masked) on the reference's params and sample."""
    jlm, p, _, tlm, _, sample = _reference(arch)
    tp = params_to_torch(_np(p), "cpu")
    jx = jlm.embed_in(p, jnp.asarray(sample), Rep.FP)
    tx = tlm.embed_in(tp, torch.from_numpy(sample))
    _close(jx, tx, "embed_in")
    jh, _, _ = jlm.apply(p, jx, Rep.FP)
    th = tlm.apply(tp, tx)
    _close(jh, th, "apply")
    jl, tl = jlm.logits(p, jh, Rep.FP), tlm.logits(tp, th)
    _close(jl, tl, "logits")
    cfg = tlm.cfg
    if cfg.vocab_padded != cfg.vocab:
        assert bool((tl[..., cfg.vocab:] == -1e9).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_equals_reference(arch):
    _, _, jc, _, tc, _ = _reference(arch)
    assert len(tc.hi) == 3 + 2 * (13 + 2 * get_config(arch).reduced(
        ).n_kv_heads)
    assert _same_ranges(jc, tc) < TOL


# which calibrator entries each deployed leaf of a layer reads
_FEEDERS = {
    "norm1": ("n1.norm1",), "norm2": ("n2.norm2",),
    "attn/q_rqt": ("attn.q",), "attn/k_rqt": ("attn.k",),
    "attn/v_rqt": ("attn.v",), "attn/score_scale": ("attn.q", "attn.k"),
    "attn/sm_tabs": ("attn.q", "attn.k"),
    "attn/ctx_rqt": ("attn.v", "attn.ctx"),
    "attn/kv4/k": ("attn.k", "attn.k.h"), "attn/kv4/v": ("attn.v", "attn.v.h"),
    "attn/wo": ("attn.ctx",),
    "add1": ("add1", "attn.ctx"),
    "mlp/g_tab": ("mlp.gate.pre", "mlp.gate"), "mlp/zp_g": ("mlp.gate",),
    "mlp/u_rqt": ("mlp.up",), "mlp/h_rqt": ("mlp.gate", "mlp.up", "mlp.h"),
    "mlp/wd": ("mlp.h",), "add2": ("add1", "add2", "mlp.h"),
}


def _feeders(path: str, layer: int):
    if path.startswith(("/norm_f/", "/meta/eps_logits")):
        return ["final.norm"]
    if not path.startswith("/segments/"):
        return []  # the embedding reads no calibrator entry
    rel = path.split("/", 3)[-1]
    for key, names in _FEEDERS.items():
        if rel.startswith(key):
            return [f"S0.L{layer}.{n}" for n in names]
    return []


def _compare_deploys(ref, got, jc, tc, path="", out=None):
    """Integer leaves equal but for entries off by one whose feeders
    are within TOL (named in `out`); float leaves within rtol 1e-5."""
    if isinstance(ref, dict):
        assert not set(got) - set(ref), path
        for k, v in ref.items():
            _compare_deploys(v, got[k], jc, tc, f"{path}/{k}", out)
        return
    if isinstance(ref, list):
        for i, (a, b) in enumerate(zip(ref, got)):
            _compare_deploys(a, b, jc, tc, f"{path}/{i}", out)
        return
    a, b = np.asarray(ref), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=path)
        return
    diff = a.astype(np.int64) != b.astype(np.int64)
    if not diff.any():
        return
    assert int(np.max(np.abs(a.astype(np.int64) - b))) <= 1, path
    layers = (np.nonzero(diff.reshape(diff.shape[0], -1).any(axis=1))[0]
              if path.startswith("/segments/") else [None])
    for layer in layers:
        names = [n for f in _feeders(path, layer) for n in jc.hi
                 if n == f or n.startswith(f)]
        assert names, (path, layer)
        for n in names:
            span = max(jc.hi[n] - jc.lo[n], 1e-6)
            assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, (path, n)
            assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, (path, n)
        out.append((path, layer, names))


@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_from_own_calibration_equals_reference(arch):
    jlm, p, jc, tlm, tc, _ = _reference(arch)
    boundary = []
    _compare_deploys(_np(jlm.deploy(p, jc)), tlm.deploy(_np(p), tc), jc, tc,
                     out=boundary)
    # every entry that moved is named with the calibrator entries behind
    # it (so far one: an exp_lut entry of chatglm3_6b's layer-1 sm_tabs,
    # from its q and k ranges)
    assert all(names for _, _, names in boundary), boundary


# -- the entry points, end to end ------------------------------------------
def _work(vocab, seed, lens=(5, 17, 33, 40, 1, 16, 9), gen=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(n,)), gen) for n in lens]


def _drain(eng, work):
    for i, (prompt, gen) in enumerate(work):
        eng.submit(copy.deepcopy(prompt), gen)
        if i < 3:
            eng.step()
    done = eng.run_until_drained()
    return [(c.req_id, list(c.tokens), c.finish_reason) for c in done]


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrated_deploy_serves_the_reference_tokens(arch, kv_bits):
    """The port's calibrate -> deploy -> ServingEngine against the
    reference's deploy_model -> ServingEngine(paged, gather oracle), on
    the reference's params: same tokens, finish reasons, order, steps."""
    jlm, jt = j_deploy_model(arch, reduced=True, max_seq=MAX_LEN)
    _, p, _, tlm, _, sample = _reference(arch)
    p_np = _np(p)
    tt = tables_from_numpy(
        tlm.deploy(p_np, tlm.calibrate(p_np, sample, device="cpu")),
        device="cpu")
    kw = dict(n_slots=3, max_len=MAX_LEN, page_size=8, kv_bits=kv_bits)
    j = JServingEngine(jlm, jt, JServingConfig(
        paged=True, paged_kernel=False,
        scheduler=JSchedulerConfig(prefill_chunk=8), **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        device="cpu", paged=True, scheduler=SchedulerConfig(prefill_chunk=8),
        **kw))
    work = _work(tlm.cfg.vocab, kv_bits)
    got = _drain(t, work)
    assert got == _drain(j, work)
    assert [len(toks) for _, toks, _ in got] == [6] * len(work)
    assert t.stats()["steps"] == j.stats()["steps"]


def test_calibration_free_deploy_stays_reachable():
    """`lm.deploy(p, None)` still deploys on DEFAULT_RANGES, as the
    reference's does, and differs from the calibrated tables."""
    jlm, p, jc, tlm, tc, _ = _reference("granite_3_2b")
    free = tlm.deploy(_np(p), None)
    seen = []

    def walk(ref, got, path=""):
        if isinstance(ref, dict):
            for k, v in ref.items():
                walk(v, got[k], f"{path}/{k}")
            return
        if isinstance(ref, list):
            for i, (a, b) in enumerate(zip(ref, got)):
                walk(a, b, f"{path}/{i}")
            return
        np.testing.assert_array_equal(np.asarray(ref), got, err_msg=path)
        seen.append(path)

    walk(_np(jlm.deploy(p, None)), free)
    assert len(seen) > 80
    cal = tlm.deploy(_np(p), tc)
    assert not np.array_equal(cal["segments"][0]["attn"]["q_rqt"]["m"],
                              free["segments"][0]["attn"]["q_rqt"]["m"])


def test_float_forward_runs_float32_whatever_the_params_dtype():
    """params_to_torch casts every leaf, in dicts and lists, to float32
    (the forward's dtype), values kept."""
    tree = {"a": np.full((2,), 0.1, np.float64),
            "b": [np.ones(3, np.float16)]}
    out = params_to_torch(tree, "cpu")
    assert out["a"].dtype == out["b"][0].dtype == torch.float32
    assert out["a"][0].item() == np.float32(0.1)
