"""FakeQuantized training of the dense family in the port, against the
JAX reference.

Held here (reduced granite_3_2b and internvl2_76b: 2 layers, d 128,
vocab 256):

  - the STE functions `pact_act`, `pact_act_asymm`, `pact_weight`,
    forward and backward against `jax.vjp` of the reference's, in
    float32 and bfloat16, edges (0, alpha, beta, +-b) included: the
    forward, dx and dw at tolerance 0, dalpha / dbeta (float32 sums in
    each side's own order) within 1e-6 of the sum of their terms'
    magnitudes; and the reference's own PACT cases (grid levels, the
    masks, one QAT step that lowers the loss);
  - `core.quantum` at tolerance 0;
  - `adamw_update` (clip on and off, float32 and bfloat16 moments),
    `cosine_schedule` and `compress_decompress_grads` on the same
    inputs as the reference run op by op: the schedule and the
    compression at tolerance 0; AdamW's params within 1 float32 ulp
    (its pow and sqrt), the entries off by one counted (MEASURED
    below);
  - `loss_fn` at Rep.FQ (granite) and `loss_fn_embeds` (internvl) with
    the reference's params and qstate carried across, against the
    reference's jitted value_and_grad: the loss within 1e-3 relative,
    every leaf's gradient within 2e-2 relative L2;
  - the trainer: `launch.train.build` + 10 steps (batch 4, seq 32)
    from the same initial state, each loss within 2e-2 relative of the
    reference's, falling and rising where the reference's does; again
    with `grad_compress=True`, and with `microbatches=2` through
    `launch.steps.build_train_step`;
  - checkpoints: round trip, keep-N and `latest_step`, the straggler
    monitor, a crash restart (`fail_at`) whose resumed losses equal the
    uninterrupted run's bit for bit, and a checkpoint of either side
    restoring into the other's tree leaf for leaf.

MEASURED (on the CPU): the FQ loss is within 2.2e-4 relative of the
jitted reference's (granite; internvl 3.2e-4) and the gradients within
1.6e-2 relative L2 (internvl 1.9e-2); run op by op, the reference's
loss is within 2.4e-7 of the port's (the port's bf16 products
accumulate in float32 and round once, as XLA's dot does; its softmax
and log_softmax are torch's) and its gradients within 7.1e-3 (XLA's
jit keeps bfloat16 chains in float32 where the port, like the
reference op by op, rounds each op).  At the init clips [-1, 6) no SiLU
output reaches a clip, so the clips' gradients are 0 on both sides;
with clips that cut they differ 2-30% (one bfloat16 ulp moves an
element across an edge), which the STE tests hold instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.configs.base import get_config as j_get_config
from repro.core import pact as jpact
from repro.core import quantum as jq
from repro.core.rep import Rep as JRep
from repro.launch import variants as j_variants
from repro.launch.steps import build_train_step as j_build_train_step
from repro.launch.train import build as j_build
from repro.models.lm import DecoderLM as JLM
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.grad_compress import (
    compress_decompress_grads as j_compress,
)
from repro.optim.schedule import cosine_schedule as j_cosine
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.core import pact, quantum
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import variants
from repro_torch.launch.elastic import StragglerMonitor, TrainSupervisor
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.launch.train import build, main as train_main
from repro_torch.models.lm import DecoderLM, params_to_torch
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    compress_decompress_grads, init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule

LOSS_TOL = 1e-3
GRAD_TOL = 2e-2
TRAJ_TOL = 2e-2
SEQ, BATCH, STEPS = 32, 4, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _to_torch(tree):
    """A jax tree (float32 / bfloat16 / int32 leaves) -> torch tensors
    with the same dtypes."""
    def one(x):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return _t(x.view(np.int16)).view(torch.bfloat16)
        return _t(x)
    return jax.tree.map(one, tree)


def _from_torch(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


# -- the STE functions ---------------------------------------------------
def _act_inputs(dtype, alpha, beta):
    rng = np.random.default_rng(5)
    x = rng.uniform(alpha - 2.0, beta + 2.0, size=(7, 41))
    x.flat[:4] = [0.0, alpha, beta, np.nextafter(beta, -np.inf)]
    x = jnp.asarray(x, dtype)
    g = jnp.asarray(rng.standard_normal(x.shape), dtype)
    return x, g


def _equal(want, got):
    want = np.asarray(want)
    got = _from_torch(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _sum_close(want, got, g, mask, tol=1e-6):
    """A clip's gradient, a float32 sum of the masked incoming gradient
    in an order of its own on each side: within `tol` of the sum of the
    terms' magnitudes (the scale of a float32 sum's rounding; relative
    to the sum itself, terms of both signs cancel without bound: 1.1e-6
    in the float32 alpha case here)."""
    scale = float(np.sum(np.abs(np.asarray(g, np.float64)) * mask))
    want, got = float(np.asarray(want, np.float64)), float(got)
    assert abs(want - got) <= tol * max(scale, 1e-30), (want, got, scale)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pact_act_forward_and_ste_equal_reference(dtype):
    beta = 2.5
    x, g = _act_inputs(dtype, 0.0, beta)
    for bits in (4, 8):
        y, vjp = jax.vjp(lambda x_, b_: jpact.pact_act(x_, b_, bits), x,
                         jnp.float32(beta))
        dx, db = vjp(g)
        xt = _to_torch(x).requires_grad_()
        bt = torch.tensor(beta, requires_grad=True)
        yt = pact.pact_act(xt, bt, bits)
        dxt, dbt = torch.autograd.grad(yt, (xt, bt), _to_torch(g))
        _equal(y, yt.detach())
        _equal(dx, dxt)
        xf = np.asarray(x, np.float32)
        _sum_close(db, dbt, g, xf >= beta)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pact_act_asymm_forward_and_ste_equal_reference(dtype):
    alpha, beta = -1.0, 3.0
    x, g = _act_inputs(dtype, alpha, beta)
    y, vjp = jax.vjp(lambda x_, a_, b_: jpact.pact_act_asymm(x_, a_, b_, 8),
                     x, jnp.float32(alpha), jnp.float32(beta))
    dx, da, db = vjp(g)
    xt = _to_torch(x).requires_grad_()
    at = torch.tensor(alpha, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    yt = pact.pact_act_asymm(xt, at, bt, 8)
    dxt, dat, dbt = torch.autograd.grad(yt, (xt, at, bt), _to_torch(g))
    _equal(y, yt.detach())
    _equal(dx, dxt)
    xf = np.asarray(x, np.float32)
    _sum_close(da, dat, g, xf < alpha)
    _sum_close(db, dbt, g, xf >= beta)


@pytest.mark.parametrize("per_channel", [True, False])
def test_pact_weight_forward_and_ste_equal_reference(per_channel):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((24, 6)).astype(np.float32)
    beta = np.abs(w).max(axis=0) * 0.8 if per_channel else np.float32(1.5)
    beta = np.asarray(beta, np.float32)
    w[0, :] = beta            # w = b: outside [-b, b)
    w[1, :] = -beta           # w = -b: inside
    g = rng.standard_normal(w.shape).astype(np.float32)
    for bits in (4, 8):
        y, vjp = jax.vjp(lambda w_: jpact.pact_weight(
            w_, jnp.asarray(beta), bits, -1), jnp.asarray(w))
        (dw,) = vjp(jnp.asarray(g))
        wt = _t(w).requires_grad_()
        bt = _t(beta).requires_grad_()
        yt = pact.pact_weight(wt, bt, bits, -1)
        dwt, dbt = torch.autograd.grad(yt, (wt, bt), _t(g))
        _equal(y, yt.detach())
        _equal(dw, dwt)
        assert not dbt.any()  # beta_w is static (reset_alpha_weights)


# the reference's tests/test_core_pact.py, on the port
def test_act_forward_on_grid():
    beta = torch.tensor(6.0)
    x = torch.linspace(-2.0, 8.0, 113)
    y = pact.pact_act(x, beta, 8)
    eps = 6.0 / 255
    q = y.numpy() / eps
    assert np.allclose(q, np.round(q), atol=1e-4)
    assert float(y.min()) >= 0 and float(y.max()) <= 6.0
    assert float(pact.pact_act(torch.tensor(-1.0), beta, 8)) == 0.0
    assert float(pact.pact_act(torch.tensor(7.0), beta, 8)) == pytest.approx(
        255 * eps)


def test_act_ste_gradients():
    beta = torch.tensor(4.0, requires_grad=True)
    x = torch.tensor([-1.0, 0.5, 2.0, 3.9, 4.5, 10.0], requires_grad=True)
    dx, db = torch.autograd.grad(pact.pact_act(x, beta, 8).sum(), (x, beta))
    np.testing.assert_array_equal(dx.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    assert float(db) == 2.0  # two clipped-high elements


def test_act_asymm_range_and_grads():
    a = torch.tensor(-1.0, requires_grad=True)
    b = torch.tensor(3.0, requires_grad=True)
    x = torch.tensor([-2.0, -0.5, 0.0, 2.9, 3.5])
    y = pact.pact_act_asymm(x, a, b, 8)
    eps = 4.0 / 255
    assert float(y[0].detach()) == pytest.approx(-1.0)
    assert float(y[-1].detach()) == pytest.approx(-1.0 + 255 * eps)
    da, db = torch.autograd.grad(y.sum(), (a, b))
    assert float(da) == 1.0 and float(db) == 1.0


@pytest.mark.parametrize("n_bits", [2, 3, 5, 8])
def test_weight_quantization_levels(n_bits):
    w = torch.from_numpy(np.random.default_rng(n_bits).standard_normal(
        (16, 8)).astype(np.float32))
    beta_w = pact.default_weight_beta(w, channel_axis=-1)
    w_hat = pact.pact_weight(w, beta_w, n_bits, -1)
    eps = 2.0 * beta_w.numpy() / (2 ** n_bits - 1)
    q = w_hat.numpy() / eps[None, :]
    assert np.allclose(q, np.round(q), atol=1e-4)
    assert np.all(np.abs(q) <= 2 ** (n_bits - 1))
    for c in range(8):
        assert len(np.unique(q[:, c].round())) <= 2 ** n_bits


def test_weight_ste():
    w = torch.tensor([[-3.0, -0.5, 0.5, 3.0]], requires_grad=True)
    (dw,) = torch.autograd.grad(
        pact.pact_weight(w, torch.ones(4), 8, -1).sum(), (w,))
    np.testing.assert_array_equal(dw.numpy(), [[0.0, 1.0, 1.0, 0.0]])


def test_qat_step_reduces_loss():
    """One SGD step through the fake-quantized graph lowers the loss
    (the end-to-end STE check, paper §2.2)."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.standard_normal((8, 4)) * 0.5).astype(
        np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    y_tgt = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
    beta = torch.tensor(2.0, requires_grad=True)

    def loss_fn(w, beta):
        w_hat = pact.pact_weight(w, pact.default_weight_beta(w), 4, -1)
        y = pact.pact_act(x @ w_hat, beta, 4)
        return torch.mean((y - y_tgt) ** 2)

    l0 = loss_fn(w, beta)
    gw, gb = torch.autograd.grad(l0, (w, beta))
    assert torch.isfinite(gw).all() and torch.isfinite(gb)
    with torch.no_grad():
        l1 = loss_fn(w - 0.05 * gw, beta - 0.05 * gb)
    assert float(l1) < float(l0.detach())


# -- core.quantum -----------------------------------------------------------
def test_quantum_equals_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 33)) * 3).astype(np.float32)
    for spec_j, spec_t in ((jq.INT8, quantum.INT8), (jq.UINT8, quantum.UINT8),
                           (jq.INT16, quantum.INT16),
                           (jq.QuantSpec(4, False),
                            quantum.QuantSpec(4, False))):
        for f in ("qmin", "qmax", "levels", "zero_point", "store_min",
                  "store_max"):
            assert getattr(spec_t, f) == getattr(spec_j, f), f
        assert np.dtype(spec_t.np_dtype) == np.dtype(spec_j.dtype)
        for rounding in ("floor", "round"):
            for eps in (0.037, np.float32(0.05)):
                want = jq.quantize_affine(jnp.asarray(x), eps, 3, spec_j,
                                          rounding=rounding)
                got = quantum.quantize_affine(_t(x), eps, 3, spec_t,
                                              rounding=rounding)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want = jq.fake_quantize(jnp.asarray(x), 0.037, -2, spec_j,
                                    rounding=rounding)
            got = quantum.fake_quantize(_t(x), 0.037, -2, spec_t,
                                        rounding=rounding)
            _equal(want, got)
    for beta, alpha in ((6.0, 0.0), (3.0, -1.0)):
        mj, mt = jq.act_qmeta(beta, alpha=alpha), quantum.act_qmeta(
            beta, alpha=alpha)
        assert (float(mt.eps), mt.zp, mt.alpha) == (float(mj.eps), mj.zp,
                                                    mj.alpha)
    w = rng.standard_normal((12, 7))
    for axis in (0, None):
        mj, mt = jq.weight_qmeta(w, channel_axis=axis), quantum.weight_qmeta(
            w, channel_axis=axis)
        np.testing.assert_array_equal(mt.eps, mj.eps)
        assert mt.per_channel == mj.per_channel
        for rounding in ("floor", "round"):
            q_j = jq.quantize_np(w, mj, rounding=rounding, channel_axis=0)
            q_t = quantum.quantize_np(w, mt, rounding=rounding,
                                      channel_axis=0)
            assert q_t.dtype == q_j.dtype
            np.testing.assert_array_equal(q_t, q_j)
            np.testing.assert_array_equal(
                quantum.dequantize_np(q_t, mt, channel_axis=0),
                jq.dequantize_np(q_j, mj, channel_axis=0))
    with pytest.raises(ValueError):
        quantum.act_qmeta(1.0, alpha=2.0)
    with pytest.raises(ValueError):
        quantum.QuantSpec(1)


# -- the optimiser ------------------------------------------------------------
def _opt_tree(rng):
    return {"b": {"w": rng.standard_normal((9, 5)).astype(np.float32)},
            "a": [rng.standard_normal((7,)).astype(np.float32),
                  np.float32(rng.standard_normal())]}


def _ulps(want, got):
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_equals_reference(moments, clip):
    """Three updates on the same gradients, the reference run op by op.
    Without the clip: step, moments and params bit for bit (its pow
    and sqrt included).  With it (the gradients are 2-4x past the
    norm): the global norm is a float32 sum of squares in each side's
    own order, so the scale may differ in its last bits; the moments
    then within 2e-6 relative and the params within 1 ulp (MEASURED:
    4 of 159 param entries, float32 moments; 0 with bfloat16 ones)."""
    rng = np.random.default_rng(4)
    p = _opt_tree(rng)
    jdt = jnp.float32 if moments == "f32" else jnp.bfloat16
    tdt = torch.float32 if moments == "f32" else torch.bfloat16
    jp = jax.tree.map(jnp.asarray, p)
    js = {"mu": jax.tree.map(lambda a: jnp.zeros(a.shape, jdt), jp),
          "nu": jax.tree.map(lambda a: jnp.zeros(a.shape, jdt), jp),
          "step": jnp.zeros((), jnp.int32)}
    tp = jax.tree.map(_t, p)
    ts = adamw_init(tp, dtype=tdt)
    off = 0
    for k in range(3):
        g = jax.tree.map(lambda a: (a * (k + 2.0)).astype(np.float32),
                         _opt_tree(np.random.default_rng(10 + k)))
        lr = np.float32(3e-4 * (k + 1))
        jp, js = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                lr=jnp.float32(lr), clip_norm=clip)
        tp, ts = adamw_update(tp, jax.tree.map(_t, g), ts,
                              lr=torch.tensor(lr), clip_norm=clip)
        assert int(ts["step"]) == int(js["step"]) == k + 1
        for name in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(js[name]),
                            tree_leaves(ts[name])):
                a = np.asarray(a, np.float64)
                b = b.double().numpy()
                if clip is None:
                    assert (_ulps(a, b) == 0).all(), name
                else:
                    assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max()
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            d = _ulps(a, b.numpy())
            assert d.max() <= (0 if clip is None else 1)
            off += int((d > 0).sum())
    assert off <= (4 if moments == "f32" else 0)


def test_cosine_schedule_equals_reference():
    steps = np.array([0, 1, 50, 99, 100, 101, 1000, 1999, 2000, 5000,
                      9999, 10000, 20000], np.int32)
    for total in (2000, 10000):
        for s in steps:
            want = np.asarray(j_cosine(jnp.int32(s), total=total))
            got = cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                  total=total)
            assert _ulps(want, got.numpy()).max() == 0, (total, s)


def test_grad_compression_equals_reference_and_feeds_back():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": [rng.standard_normal((3,)).astype(np.float32)]}
    je = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), g)
    te = init_error_feedback(jax.tree.map(_t, g))
    acc = np.zeros((64, 64))
    for _ in range(50):
        jd, je = j_compress(jax.tree.map(jnp.asarray, g), je)
        td, te = compress_decompress_grads(jax.tree.map(_t, g), te)
        for a, b in zip(jax.tree.leaves(jd) + jax.tree.leaves(je),
                        tree_leaves(td) + tree_leaves(te)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        acc += td["w"].numpy()
    # error feedback: the accumulated sum within a step of the truth
    scale = float(np.abs(g["w"]).max()) / 127.0
    assert np.abs(acc - g["w"] * 50).max() <= 2 * scale


# -- the FQ loss and gradients ---------------------------------------------
def _rel_l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    den = np.linalg.norm(want)
    if den == 0:
        return float(np.linalg.norm(got) > 0)
    return float(np.linalg.norm(want - got) / den)


@pytest.fixture(scope="module")
def granite():
    """The reference's trainer (`launch.train.build`, its jitted step)
    and the port's on the same initial state."""
    jlm, jtr, jopt, jstep, stream = j_build(
        "granite_3_2b", reduced=True, seq=SEQ, batch=BATCH)
    lm, _, _, step, _ = build("granite_3_2b", reduced=True, seq=SEQ,
                              batch=BATCH, device="cpu")
    return {"jlm": jlm, "jtr": jtr, "jopt": jopt, "jstep": jstep,
            "stream": stream, "lm": lm, "step": step,
            "tr": params_to_torch(_np(jtr), "cpu")}


def _grads_close(jg, tg):
    """Every leaf's gradient within GRAD_TOL relative L2; -> the worst."""
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    worst = 0.0
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        worst = max(worst, _rel_l2(a, b.numpy()))
    assert worst <= GRAD_TOL, worst
    return worst


def test_fq_loss_and_gradients_equal_reference(granite):
    jlm, lm = granite["jlm"], granite["lm"]
    tok = granite["stream"].batch(0)
    jl, jg = jax.jit(jax.value_and_grad(lambda tr: jlm.loss_fn(
        tr["params"], tr["qstate"], jnp.asarray(tok), JRep.FQ)))(
            granite["jtr"])
    tl, tg = value_and_grad(lambda tr, t: lm.loss_fn(
        tr["params"], tr["qstate"], t, Rep.FQ), granite["tr"], _t(tok))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    _grads_close(jg, tg)


def test_fq_loss_embeds_and_gradients_equal_reference():
    jlm = JLM(j_get_config("internvl2_76b").reduced(), max_seq=SEQ)
    tr = {"params": jlm.init(jax.random.PRNGKey(2)),
          "qstate": jlm.init_qstate()}
    rng = np.random.default_rng(6)
    emb = (rng.standard_normal((2, SEQ, 128)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, jlm.cfg.vocab, size=(2, SEQ)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda t: jlm.loss_fn_embeds(
        t["params"], t["qstate"], jnp.asarray(emb), jnp.asarray(tgt),
        JRep.FQ)))(tr)
    lm = DecoderLM(get_config("internvl2_76b").reduced(), max_seq=SEQ)
    tl, tg = value_and_grad(lambda t, e, y: lm.loss_fn_embeds(
        t["params"], t["qstate"], e, y, Rep.FQ),
        params_to_torch(_np(tr), "cpu"), _t(emb), _t(tgt))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    _grads_close(jg, tg)


def test_other_families_raise_on_training():
    """What the port still does not train: llama4_maverick cut to an odd
    depth (its pairs need an even n_layers; the reference's plan asserts,
    the port refuses at construction), a llama4 batch that does not
    divide into MoE groups (the reference asserts) and `build` of an
    embeds model (its stream feeds token ids).  Every other family trains
    (`tests/test_torch_train_moe.py`, `tests/test_torch_train_ssm.py`),
    the bf16 scan island (10c) too: under ``ssm_island_dtype="bf16"``
    the first train step's FQ loss of reduced falcon_mamba_7b and
    zamba2_1_2b at two chunks of 128 tokens is within LOSS_TOL of the
    reference's jitted loss under the variant."""
    jcfg = j_get_config("llama4_maverick_400b_a17b").reduced()
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(ArchConfig)})
    with pytest.raises(AssertionError):
        JLM(dataclasses.replace(jcfg, n_layers=3), max_seq=SEQ).plan()
    with pytest.raises(ValueError, match="must be even"):
        DecoderLM(dataclasses.replace(cfg, n_layers=3), max_seq=SEQ)
    lm, tr, _, _, _ = build("llama4_maverick_400b_a17b", reduced=True,
                            seq=48, batch=2, device="cpu")
    assert lm.pair and set(tr["qstate"]["segments"][0]) == {"a", "b"}
    with pytest.raises(ValueError, match="MoE groups"):
        lm.loss_fn(tr["params"], tr["qstate"],
                   torch.zeros((2, 49), dtype=torch.int32), Rep.FQ)
    jlm4, jtr4, _, _, _ = j_build("llama4_maverick_400b_a17b", reduced=True,
                                  seq=48, batch=2)
    with pytest.raises(AssertionError):
        jlm4.loss_fn(jtr4["params"], jtr4["qstate"],
                     jnp.zeros((2, 49), jnp.int32), JRep.FQ)
    for arch in ("falcon_mamba_7b", "zamba2_1_2b"):
        with variants.use_variants(ssm_island_dtype="bf16"), \
                j_variants.use_variants(ssm_island_dtype="bf16"):
            jlm, jtr, _, _, stream = j_build(arch, reduced=True, seq=256,
                                             batch=1)
            tok = stream.batch(0)
            jl = jax.jit(lambda t: jlm.loss_fn(
                t["params"], t["qstate"], jnp.asarray(tok), JRep.FQ))(jtr)
            lm = DecoderLM(get_config(arch).reduced(), max_seq=257)
            tr = params_to_torch(_np(jtr), "cpu")
            loss, _, _ = build_train_step(lm)(tr, adamw_init(tr),
                                              {"tokens": _t(tok)})
        assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    with pytest.raises(ValueError, match="build_train_step"):
        build("internvl2_76b", reduced=True, seq=SEQ, batch=2, device="cpu")


# -- the trainer ------------------------------------------------------------
def _trajectory(step, tr, opt, batches):
    losses = []
    for b in batches:
        loss, tr, opt = step(tr, opt, b)
        losses.append(float(loss))
    return losses


def _same_trajectory(jlosses, tlosses):
    """Each loss within TRAJ_TOL relative; and the port's loss falls
    (and rises) where the reference's does: over 10 warm-up steps the
    loss moves with each step's batch (granite: 5.93, 6.07, 5.89, ...;
    it falls over 20, `test_crash_restart_resumes_bit_for_bit`), so
    every step's change above 0.02 has the reference's sign (MEASURED:
    the losses within 5e-4 relative)."""
    for a, b in zip(jlosses, tlosses):
        assert abs(a - b) <= TRAJ_TOL * abs(a), (jlosses, tlosses)
    dj, dt = np.diff(jlosses), np.diff(tlosses)
    big = np.abs(dj) > 0.02
    assert big.sum() >= 3 and (np.sign(dj) == np.sign(dt))[big].all(), (
        jlosses, tlosses)


def test_trainer_trajectory_equals_reference(granite):
    g = granite
    jb = [jnp.asarray(g["stream"].batch(s)) for s in range(STEPS)]
    want = _trajectory(g["jstep"], g["jtr"], g["jopt"], jb)
    got = _trajectory(g["step"], g["tr"], adamw_init(g["tr"]),
                      [_t(g["stream"].batch(s)) for s in range(STEPS)])
    _same_trajectory(want, got)


def test_trainer_with_grad_compression_equals_reference(granite):
    g = granite
    _, _, jopt, jstep, _ = j_build("granite_3_2b", reduced=True, seq=SEQ,
                                   batch=BATCH, grad_compress=True)
    _, _, opt, step, _ = build("granite_3_2b", reduced=True, seq=SEQ,
                               batch=BATCH, grad_compress=True, device="cpu")
    assert set(opt) == set(jopt) == {"mu", "nu", "step", "err_fb"}
    want = _trajectory(jstep, g["jtr"], jopt, [
        jnp.asarray(g["stream"].batch(s)) for s in range(STEPS)])
    got = _trajectory(step, g["tr"], {**adamw_init(g["tr"]), "err_fb":
                                      opt["err_fb"]},
                      [_t(g["stream"].batch(s)) for s in range(STEPS)])
    _same_trajectory(want, got)


def test_microbatched_train_step_equals_reference(granite):
    g = granite
    jstep = jax.jit(j_build_train_step(g["jlm"], microbatches=2))
    step = build_train_step(g["lm"], microbatches=2)
    want = _trajectory(jstep, g["jtr"], g["jopt"], [
        {"tokens": jnp.asarray(g["stream"].batch(s))} for s in range(STEPS)])
    got = _trajectory(step, g["tr"], adamw_init(g["tr"]), [
        {"tokens": _t(g["stream"].batch(s))} for s in range(STEPS)])
    _same_trajectory(want, got)


# -- checkpoints and the supervisor ---------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int8),
                  "h": torch.linspace(-2, 2, 7).to(torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32), "l": [torch.zeros(2)]}
    ckpt.save(tmp_path, 3, tree)
    back = ckpt.restore(tmp_path, 3, tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, 3, {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 3, {**tree, "a": torch.zeros(4, 3)})


def test_checkpoint_keep_n_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "none") is None


def test_straggler_monitor():
    mon = StragglerMonitor(window=16, threshold=3.0)
    for s in range(12):
        assert not mon.observe(s, 0.1 + 0.001 * s)
    assert mon.observe(12, 1.0)  # 10x median
    assert mon.flagged and mon.flagged[0][0] == 12


def test_crash_restart_resumes_bit_for_bit(tmp_path, granite):
    """20 steps with an injected failure at 12 and a restart: the
    resumed steps' losses equal the uninterrupted run's bit for bit."""
    g = granite

    def sup(path, **kw):
        return TrainSupervisor(
            train_step=g["step"], make_batch=lambda s: _t(
                g["stream"].batch(s)), ckpt_dir=str(path), **kw)

    tr0, opt0 = g["tr"], adamw_init(g["tr"])
    with pytest.raises(RuntimeError, match="injected node failure"):
        sup(tmp_path / "a", ckpt_every=5, fail_at=12).run(tr0, opt0,
                                                         n_steps=20)
    assert ckpt.latest_step(tmp_path / "a") == 10
    out = sup(tmp_path / "a", ckpt_every=5).run(tr0, opt0, n_steps=20)
    assert out["status"] == "done" and out["step"] == 20
    assert len(out["losses"]) == 10
    ref = sup(tmp_path / "b", ckpt_every=100).run(tr0, opt0, n_steps=20)
    assert out["losses"] == ref["losses"][10:]
    assert np.mean(ref["losses"][10:]) < np.mean(ref["losses"][:10])


def test_checkpoints_interchange_with_the_reference(tmp_path, granite):
    """The reference's `manager.save` of its {"trainable", "opt"} state
    restores into the port's tree leaf for leaf, and the reverse."""
    g = granite
    jstate = {"trainable": g["jtr"], "opt": g["jopt"]}
    _, jtr1, jopt1 = g["jstep"](g["jtr"], g["jopt"],
                                jnp.asarray(g["stream"].batch(0)))
    j_ckpt.save(tmp_path / "j", 1, {"trainable": jtr1, "opt": jopt1})
    like = {"trainable": g["tr"], "opt": adamw_init(g["tr"])}
    got = ckpt.restore(tmp_path / "j", 1, like)
    want = jax.tree.leaves({"trainable": jtr1, "opt": jopt1})
    assert len(want) == len(tree_leaves(got))
    for a, b in zip(want, tree_leaves(got)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _, tr1, opt1 = g["step"](g["tr"], adamw_init(g["tr"]),
                             _t(g["stream"].batch(0)))
    ckpt.save(tmp_path / "t", 1, {"trainable": tr1, "opt": opt1})
    back = j_ckpt.restore(tmp_path / "t", 1, jstate)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(
            {"trainable": tr1, "opt": opt1})):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train_main(["--arch", "granite_3_2b", "--reduced", "--device",
                      "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path), "--grad-compress"])
    assert out["status"] == "done" and ckpt.latest_step(tmp_path) == 3
    assert "status=done step=3" in capsys.readouterr().out
