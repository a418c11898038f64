"""FakeQuantized training of the MoE family (olmoe_1b_7b) in the port,
against the JAX reference, and the float pieces it is built from.

Held here (reduced olmoe_1b_7b: 2 layers, d 128, 4 experts top-2, MoE
groups of 64; batch 4 x 64 tokens, four groups):

  - at tolerance 0 against the reference's functions: `_fq_w3` (value
    and straight-through mask), `QMoE.aux_loss`, `QMoE.init_qstate`,
    `core.island.softmax_f32` (rows of 4, 8, 64 and 512) and `act_fn`,
    and `QAct`'s `init_qstate`, `apply_fp` (and what it observes),
    `apply_fq` and its STE mask, `qd_state`, `apply_qd` and the
    `apply` dispatch, for every activation kind in float32 and
    bfloat16 (the clips' gradients, float32 sums, and SiLU's / GELU's
    derivative within stated bounds);
  - the MoE quirk behind olmoe's tokens by arena (ROADMAP §3): a decode
    group's parked rows take expert capacity, in the reference and the
    port alike;
  - the island's gradients (`exp_f32`, `softplus_f32`, `rsqrt_f32`,
    `tanh_f32`, `fma`, `softmax_f32`) against jax's of the plain
    operations, and their forward bits with gradients on equal to the
    serving bits;
  - `loss_fn` at Rep.FQ through `launch.train.build`, against the
    reference run op by op (`jax.disable_jit()`): the loss within 1e-5
    relative, no (token, expert) choice different in any layer, every
    gradient leaf within GRAD_TOL_EAGER relative L2; and against both
    the jitted and the op-by-op reference, the loss and every leaf
    within 1.5x the reference's own jit-vs-op-by-op gap on the same
    batch; the FP loss (with 0.01 aux) held the same way;
  - the trainer (10 steps) under `test_torch_train._same_trajectory`,
    a crash restart that resumes bit for bit, checkpoints that cross to
    the reference's tree and back, the CLI, and the group check (B x S
    must divide into MoE groups, as the reference asserts).

MEASURED (on the CPU, this batch): the port's FQ loss is within 3.7e-6
relative of the op-by-op reference's (its bf16 products accumulate in
float32 and round once, its routing softmax and aux_loss are the
reference lowering's; the attention's softmax is torch's, a last ulp
apart on some probabilities), no routing choice differs, and the
gradients are within 8.0e-3 (router 6.5e-3); the jit-vs-op-by-op gap
is 1.0e-3 in the loss and 2.2e-2 to 8.3e-2 in the leaves.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.rep import Rep as JRep
from repro.launch.train import build as j_build
from repro.layers.act_quant import QAct as JQAct
from repro.layers.common import ActKind as JActKind
from repro.layers.common import DeployCtx as JDeployCtx
from repro.layers.common import act_fn as j_act_fn
from repro.layers.moe import QMoE as JQMoE
from repro.layers.moe import _fq_w3 as j_fq_w3
from repro.models.lm import _tree_slice
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import island
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.elastic import TrainSupervisor
from repro_torch.launch.steps import value_and_grad
from repro_torch.launch.train import build, main as train_main
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import ActKind, DeployCtx, act_fn
from repro_torch.layers.moe import QMoE, _fq_w3
from repro_torch.models.lm import params_to_torch, tree_to_torch
from repro_torch.optim.adamw import adamw_init
from test_torch_train import _rel_l2, _same_trajectory

ARCH = "olmoe_1b_7b"
SEQ, BATCH, STEPS = 64, 4, 10
LOSS_TOL_EAGER = 1e-5
GRAD_TOL_EAGER = 1e-2   # MEASURED 8.0e-3 (module docstring)
GAP = 1.5               # the port within 1.5x the reference's own gap
# SiLU's / GELU's derivative, rounded in another order by each autodiff
# (relative L2; MEASURED 2.4e-7 in float32, 7.3e-3 in bfloat16: GELU)
ACT_GRAD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


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


def _j2t(x):
    """A jax array (float32 / bfloat16) -> a torch tensor, same bits."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return _t(x.view(np.int16)).view(torch.bfloat16)
    return _t(x)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int32 if a.dtype == torch.float32
                              else np.int64)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)


def _same_bits(want, got):
    assert tuple(np.shape(want)) == tuple(got.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- the pieces at tolerance 0 ----------------------------------------------
def test_fq_w3_value_and_ste_equal_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 24, 10)).astype(np.float32)
    beta = np.maximum(np.abs(w).max(axis=1), 1e-8).astype(np.float32)
    b = beta * np.float32(0.75)          # a grid that clips
    w[:, 0, :] = b                       # w = b: outside [-b, b)
    w[:, 1, :] = -b                      # w = -b: inside
    g = rng.standard_normal(w.shape).astype(np.float32)
    for bb in (beta, b):
        y, vjp = jax.vjp(lambda w_: j_fq_w3(w_, jnp.asarray(bb)),
                         jnp.asarray(w))
        (dw,) = vjp(jnp.asarray(g))
        wt = _t(w).requires_grad_()
        yt = _fq_w3(wt, _t(bb))
        (dwt,) = torch.autograd.grad(yt, (wt,), _t(g))
        _same_bits(y, yt)
        _same_bits(dw, dwt)
        mask = (w >= -bb[:, None, :]) & (w < bb[:, None, :])
        np.testing.assert_array_equal(dwt.numpy(), np.where(mask, g, 0.0))


@pytest.mark.parametrize("G,Gs,E,k", [(4, 64, 4, 2), (1, 512, 64, 8),
                                      (2, 64, 64, 8)])
def test_aux_loss_equals_reference(G, Gs, E, k):
    rng = np.random.default_rng(E + k)
    logits = (rng.standard_normal((G, Gs, E)) * 2).astype(np.float32)
    _, experts = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    j, t = JQMoE(32, 32, E, k, group_size=Gs), QMoE(32, 32, E, k,
                                                     group_size=Gs)
    with jax.disable_jit():
        want = j.aux_loss(jnp.asarray(logits), experts)
    got = t.aux_loss(_t(logits), _t(experts).long())
    _same_bits(want, got)
    _same_bits(jax.jit(j.aux_loss)(jnp.asarray(logits), experts), got)


def test_qmoe_init_qstate_equals_reference():
    want = JQMoE(32, 32, 4, 2).init_qstate()
    got = QMoE(32, 32, 4, 2).init_qstate("cpu")
    assert sorted(want) == sorted(got) == ["alpha", "beta"]
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        _same_bits(want[k], got[k])


@pytest.mark.parametrize("n", [4, 8, 64, 512])
def test_softmax_f32_equals_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, 17, n)) * 3).astype(np.float32)
    x[0, 0, 1:] = -1e9                   # a masked row
    g = rng.standard_normal(x.shape).astype(np.float32)
    with jax.disable_jit():
        y, vjp = jax.vjp(lambda a: jax.nn.softmax(a, axis=-1),
                         jnp.asarray(x))
        (dx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    yt = island.softmax_f32(xt)
    _same_bits(y, yt)
    _same_bits(jax.jit(jax.nn.softmax)(jnp.asarray(x)), yt)
    (dxt,) = torch.autograd.grad(yt, (xt,), _t(g))
    assert _rel_l2(dx, dxt.numpy()) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["silu", "gelu", "relu", "relu2"])
def test_act_fn_equals_reference(kind, dtype):
    rng = np.random.default_rng(1)
    x = np.concatenate([(rng.standard_normal(20000) * 4),
                        np.linspace(-12, 12, 4001)]).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    with jax.disable_jit():
        want = j_act_fn(JActKind(kind), xj)
    _same_bits(want, act_fn(ActKind(kind), _j2t(xj)))


def _island_cases():
    """(name, port fn, jax fn, input) for the differentiable island
    ops."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    pos = np.abs(x) + np.float32(0.1)
    return [("exp", island.exp_f32, jnp.exp, x),
            ("softplus", island.softplus_f32, jax.nn.softplus, x),
            ("rsqrt", island.rsqrt_f32, jax.lax.rsqrt, pos),
            ("tanh", island.tanh_f32, jnp.tanh, x)]


def test_island_gradients_equal_reference_and_keep_the_bits():
    """Each island op with gradients on: its forward bits are the
    serving bits (no gradient), and its gradient is jax's of the plain
    operation within 1e-6 relative L2 (the analytic derivative)."""
    g = np.random.default_rng(9).standard_normal(4096).astype(np.float32)
    for name, fn, jfn, x in _island_cases():
        xt = _t(x).requires_grad_()
        y = fn(xt)
        _same_bits(fn(_t(x)), y)
        (dx,) = torch.autograd.grad(y, (xt,), _t(g))
        _, vjp = jax.vjp(jfn, jnp.asarray(x))
        assert _rel_l2(vjp(jnp.asarray(g))[0], dx.numpy()) <= 1e-6, name
    rng = np.random.default_rng(10)
    a, b = (_t(rng.standard_normal((5, 7)).astype(np.float32))
            .requires_grad_() for _ in range(2))
    c = _t(rng.standard_normal((7,)).astype(np.float32)).requires_grad_()
    y = island.fma(a, b, c)
    _same_bits(island.fma(a.detach(), b.detach(), c.detach()), y)
    gy = _t(rng.standard_normal((5, 7)).astype(np.float32))
    da, db, dc = torch.autograd.grad(y, (a, b, c), gy)
    assert torch.equal(da, gy * b.detach()) and torch.equal(
        db, gy * a.detach()) and torch.equal(dc, gy.sum(0))
    (dx,) = torch.autograd.grad(island.ftz(a * 1e-39), (a,), gy)
    assert torch.equal(dx, gy * 1e-39)


# -- QAct's float forwards ----------------------------------------------------
KINDS = ["identity", "relu", "relu2", "silu", "gelu"]


def _act_x(dtype):
    rng = np.random.default_rng(4)
    x = rng.uniform(-9.0, 9.0, size=(6, 97))
    x.flat[:6] = [0.0, -6.0, 6.0, -1.0, 2.5, np.nextafter(6.0, 0.0)]
    return jnp.asarray(x, jnp.dtype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_qact_float_forwards_equal_reference(kind, dtype):
    """apply_fp (and its observed ranges), apply_fq (forward and dx),
    qd_state, apply_qd and the apply dispatch at tolerance 0; the clips'
    gradients as `test_torch_train._sum_close` holds PACT's (float32
    sums of the masked incoming gradient, 1 ulp apart here);
    init_qstate's leaves."""
    j, t = JQAct(JActKind(kind), name="a"), QAct(ActKind(kind), name="a")
    x = _act_x(dtype)
    xt = _j2t(x)
    jc, tc = JCalibrator(), Calibrator()
    _same_bits(j.apply_fp(x, calib=jc, scope="s."),
               t.apply_fp(xt, calib=tc, scope="s."))
    assert list(tc.hi) == list(jc.hi)
    for n in jc.hi:
        assert (tc.lo[n], tc.hi[n]) == (float(jc.lo[n]), float(jc.hi[n]))
    jq, tq = j.init_qstate(), t.init_qstate("cpu")
    assert sorted(jq) == sorted(tq)
    for k in jq:
        _same_bits(jq[k], tq[k])
    jq = {k: v * 0.5 for k, v in jq.items()}   # clips that cut
    tq = {k: (v * 0.5).requires_grad_() for k, v in tq.items()}
    g = jnp.asarray(np.random.default_rng(5).standard_normal(x.shape),
                    x.dtype)
    y, vjp = jax.vjp(lambda x_, q_: j.apply_fq(q_, x_), x, jq)
    dx, dq = vjp(g)
    xg = xt.clone().requires_grad_()
    yt = t.apply(tq, xg, Rep.FQ)
    _same_bits(y, yt)
    grads = torch.autograd.grad(yt, [xg] + [tq[k] for k in sorted(tq)],
                                _j2t(g))
    # the STE: dx 0 outside the clips on both sides; inside, the
    # piecewise-linear kinds' dx equal (a zero's sign aside), SiLU's and
    # GELU's their derivative as each autodiff rounds it (ACT_GRAD_TOL)
    dxt, dxj = grads[0].float().numpy(), np.asarray(dx, np.float32)
    yf = np.asarray(j_act_fn(JActKind(kind), x), np.float32)
    masks = {"alpha": yf < np.float32(jq.get("alpha", 0.0)),
             "beta": yf >= np.float32(jq["beta"])}
    outside = masks["alpha"] | masks["beta"]
    assert not dxt[outside].any() and not dxj[outside].any()
    if kind in ("silu", "gelu"):
        assert _rel_l2(dxj, dxt) <= ACT_GRAD_TOL[dtype], _rel_l2(dxj, dxt)
    else:
        np.testing.assert_array_equal(dxt, dxj)
    # each clip's gradient a float32 sum in each side's own order, within
    # 1e-6 of its terms' magnitudes
    gf = np.asarray(g, np.float64)
    for k, gk in zip(sorted(tq), grads[1:]):
        scale = float(np.sum(np.abs(gf) * masks[k]))
        assert abs(float(dq[k]) - float(gk)) <= 1e-6 * max(scale, 1e-30), k
    jd = j.qd_state(JDeployCtx(calib=jc), "s.")
    td = t.qd_state(DeployCtx(calib=tc), "s.")
    assert jd.keys() == td.keys()
    for k in jd:
        assert jd[k].dtype == td[k].dtype and jd[k] == td[k]
    _same_bits(j.apply_qd(jd, x), t.apply(td, xt, Rep.QD))
    _same_bits(j.apply(None, x, JRep.FP), t.apply(None, xt, Rep.FP))


# -- parked rows in a decode group (ROADMAP §3) ----------------------------
def test_parked_rows_take_expert_capacity_as_the_reference_does():
    """olmoe's tokens by arena, classified: a decode dispatch of 8 slot
    rows is one MoE group (capacity 4 at 64 experts top-8), and its
    parked rows route and take capacity as active ones do, earlier rows
    first.  The same active rows behind other parked rows (the slot
    arena's stale rows, the paged arena's trash page) lose other
    (token, expert) choices and give other outputs, in the reference's
    `QMoE.apply_id` and the port's alike (both bit for bit)."""
    E, k, d, f = 64, 8, 64, 96
    j, t = JQMoE(d, f, E, k, group_size=8), QMoE(d, f, E, k, group_size=8)
    p = j.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, d)).astype(np.float32)
    jc = JCalibrator()
    j.apply_float(p, jnp.asarray(x), JRep.FP, calib=jc, scope="s.")
    tj, _ = j.deploy(JDeployCtx(calib=jc), "s.", _np(p), 0.05, 0)
    tt, _ = t.deploy(DeployCtx(calib=jc), "s.", _np(p), 0.05, 0)
    tt = tree_to_torch(tt, "cpu")
    base = rng.integers(-90, 91, size=d)

    def rows(sign):
        return np.clip(sign * base + rng.integers(-3, 4, size=(4, d)),
                       -128, 127).astype(np.int8)

    active = rows(1)
    outs, drops = [], []
    for parked in (rows(1), rows(-1)):      # the same experts, or others
        s = np.concatenate([parked, active])
        want = np.asarray(j.apply_id(jax.tree.map(jnp.asarray, tj),
                                     jnp.asarray(s)))
        got = t.apply_id(tt, _t(s))
        np.testing.assert_array_equal(got.numpy(), want)
        s_gates = t.route_id(tt, _t(s)[None])[0][0]
        drops.append(int((s_gates[4:] == 0).sum()))
        outs.append(want[4:])
    print(f"active rows' dropped choices {drops}, outputs differing "
          f"{int((outs[0] != outs[1]).sum())} of {outs[0].size}")
    assert drops[0] > drops[1] and not np.array_equal(outs[0], outs[1])


# -- the FQ loss and gradients of reduced olmoe ---------------------------
@contextlib.contextmanager
def _routes(cls):
    """Record the experts every `_route` of `cls` picks (concrete values
    only: an op-by-op or a torch forward)."""
    orig, seen = cls._route, []

    def rec(self, logits, *a, **kw):
        out = orig(self, logits, *a, **kw)
        seen.append(np.asarray(out[1]))
        return out

    cls._route = rec
    try:
        yield seen
    finally:
        cls._route = orig


def _reference_routes(jlm, jtr, tok):
    """The experts each MoE layer of the reference picks: its scan body
    run layer by layer (op by op; under the scan, remat traces)."""
    ((_, tpl, n),) = jlm.plan()
    seg, qs = jtr["params"]["segments"][0], jtr["qstate"]["segments"][0]
    x = jlm.embed_in(jtr["params"], jnp.asarray(tok[:, :-1]), JRep.FQ)
    x = x.astype(jnp.bfloat16)
    with _routes(JQMoE) as seen:
        for i in range(n):
            x, _, _ = tpl.apply_float(_tree_slice(seg, i), x, JRep.FQ,
                                      qs=_tree_slice(qs, i))
    return seen


@pytest.fixture(scope="module")
def olmoe():
    """The reference's trainer and the port's on the same initial state
    and batch: the FQ value and gradient jitted, op by op and on the
    port; the FP loss on each; each side's routing (a forward)."""
    jlm, jtr, jopt, jstep, stream = j_build(ARCH, reduced=True, seq=SEQ,
                                            batch=BATCH)
    lm, _, _, step, _ = build(ARCH, reduced=True, seq=SEQ, batch=BATCH,
                              device="cpu")
    tok = stream.batch(0)
    tr = params_to_torch(_np(jtr), "cpu")

    def jloss(rep):
        return lambda t: jlm.loss_fn(t["params"], t["qstate"],
                                     jnp.asarray(tok), rep)

    def tloss(rep):
        return lambda t, x: lm.loss_fn(t["params"], t["qstate"], x, rep)

    out = {"jlm": jlm, "jtr": jtr, "jopt": jopt, "jstep": jstep,
           "stream": stream, "lm": lm, "step": step, "tr": tr}
    out["jit"] = jax.jit(jax.value_and_grad(jloss(JRep.FQ)))(jtr)
    out["jit_fp"] = float(jax.jit(jloss(JRep.FP))(jtr))
    with jax.disable_jit():
        out["eager"] = jax.value_and_grad(jloss(JRep.FQ))(jtr)
        out["eager_routes"] = _reference_routes(jlm, jtr, tok)
        out["eager_fp"] = float(jloss(JRep.FP)(jtr))
    out["port"] = value_and_grad(tloss(Rep.FQ), tr, _t(tok))
    with torch.no_grad():
        with _routes(QMoE) as seen:
            tloss(Rep.FQ)(tr, _t(tok))
        out["port_routes"] = seen
        out["port_fp"] = float(tloss(Rep.FP)(tr, _t(tok)))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(a)


def test_fq_loss_routing_and_gradients_equal_reference_op_by_op(olmoe):
    (el, eg), (tl, tg) = olmoe["eager"], olmoe["port"]
    assert _rel(float(el), float(tl)) <= LOSS_TOL_EAGER
    routes_j, routes_t = olmoe["eager_routes"], olmoe["port_routes"]
    assert len(routes_j) == len(routes_t) == olmoe["lm"].cfg.n_layers
    differ = sum(int((a != b).sum()) for a, b in zip(routes_j, routes_t))
    assert differ == 0
    jl, tl_ = jax.tree.leaves(eg), tree_leaves(tg)
    assert len(jl) == len(tl_) == 15
    worst = max(_rel_l2(a, b.numpy()) for a, b in zip(jl, tl_))
    assert worst <= GRAD_TOL_EAGER, worst


def _within_gap(jit, eager, port, what):
    """port within GAP x |jit - eager| of both reference runs."""
    gap = abs(jit - eager)
    assert abs(port - jit) <= GAP * gap, (what, jit, eager, port)
    assert abs(port - eager) <= GAP * gap, (what, jit, eager, port)


def check_against_both_runs(jit, eager, port):
    """The loss and every gradient leaf within GAP x the reference's own
    jit-vs-op-by-op gap, against both runs."""
    (jl, jg), (el, eg), (tl, tg) = jit, eager, port
    _within_gap(float(jl), float(el), float(tl), "loss")
    for a, e, t in zip(jax.tree.leaves(jg), jax.tree.leaves(eg),
                       tree_leaves(tg)):
        gap = _rel_l2(a, e)
        assert _rel_l2(a, t.numpy()) <= GAP * gap, (gap, _rel_l2(
            a, t.numpy()))
        assert _rel_l2(e, t.numpy()) <= GAP * gap


def test_fq_loss_and_gradients_within_the_reference_gap(olmoe):
    check_against_both_runs(olmoe["jit"], olmoe["eager"], olmoe["port"])


def test_fp_loss_with_aux_equals_reference(olmoe):
    """The FullPrecision loss (+ 0.01 aux, added at every float rep)."""
    jit, eager, port = olmoe["jit_fp"], olmoe["eager_fp"], olmoe["port_fp"]
    assert _rel(eager, port) <= LOSS_TOL_EAGER
    _within_gap(jit, eager, port, "fp loss")


# -- the trainer, checkpoints, the CLI -----------------------------------
def _trajectory(step, tr, opt, batches):
    losses = []
    for b in batches:
        loss, tr, opt = step(tr, opt, b)
        losses.append(float(loss))
    return losses


def test_trainer_trajectory_equals_reference(olmoe):
    g = olmoe
    want = _trajectory(g["jstep"], g["jtr"], g["jopt"], [
        jnp.asarray(g["stream"].batch(s)) for s in range(STEPS)])
    got = _trajectory(g["step"], g["tr"], adamw_init(g["tr"]), [
        _t(g["stream"].batch(s)) for s in range(STEPS)])
    _same_trajectory(want, got)


def test_crash_restart_resumes_bit_for_bit(tmp_path, olmoe):
    g = olmoe

    def sup(path, **kw):
        return TrainSupervisor(
            train_step=g["step"], make_batch=lambda s: _t(
                g["stream"].batch(s)), ckpt_dir=str(path), **kw)

    tr0, opt0 = g["tr"], adamw_init(g["tr"])
    with pytest.raises(RuntimeError, match="injected node failure"):
        sup(tmp_path / "a", ckpt_every=2, fail_at=5).run(tr0, opt0,
                                                        n_steps=6)
    assert ckpt.latest_step(tmp_path / "a") == 4
    out = sup(tmp_path / "a", ckpt_every=2).run(tr0, opt0, n_steps=6)
    assert out["status"] == "done" and len(out["losses"]) == 2
    ref = sup(tmp_path / "b", ckpt_every=100).run(tr0, opt0, n_steps=6)
    assert out["losses"] == ref["losses"][4:]


def test_checkpoints_interchange_with_the_reference(tmp_path, olmoe):
    """The MoE's clip layout ({"segments": [{"moe": {alpha, beta}}]})
    through AdamW and both checkpoint managers, leaf for leaf."""
    g = olmoe
    _, jtr1, jopt1 = g["jstep"](g["jtr"], g["jopt"],
                                jnp.asarray(g["stream"].batch(0)))
    j_ckpt.save(tmp_path / "j", 1, {"trainable": jtr1, "opt": jopt1})
    like = {"trainable": g["tr"], "opt": adamw_init(g["tr"])}
    got = ckpt.restore(tmp_path / "j", 1, like)
    want = jax.tree.leaves({"trainable": jtr1, "opt": jopt1})
    assert len(want) == len(tree_leaves(got))
    for a, b in zip(want, tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _, tr1, opt1 = g["step"](g["tr"], adamw_init(g["tr"]),
                             _t(g["stream"].batch(0)))
    ckpt.save(tmp_path / "t", 1, {"trainable": tr1, "opt": opt1})
    back = j_ckpt.restore(tmp_path / "t", 1,
                          {"trainable": g["jtr"], "opt": g["jopt"]})
    for a, b in zip(jax.tree.leaves(back), tree_leaves(
            {"trainable": tr1, "opt": opt1})):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_batch_must_divide_into_moe_groups():
    """B x S tokens not a multiple of the group (64 reduced) raise, as
    the reference's `QMoE._group` asserts."""
    lm, tr, _, _, _ = build(ARCH, reduced=True, seq=48, batch=2,
                            device="cpu")
    tok = torch.zeros((2, 49), dtype=torch.int32)
    with pytest.raises(ValueError, match="MoE groups"):
        lm.loss_fn(tr["params"], tr["qstate"], tok, Rep.FQ)
    jlm, jtr, _, _, _ = j_build(ARCH, reduced=True, seq=48, batch=2)
    with pytest.raises(AssertionError):
        jlm.loss_fn(jtr["params"], jtr["qstate"],
                    jnp.zeros((2, 49), jnp.int32), JRep.FQ)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train_main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--ckpt", str(tmp_path)])
    assert out["status"] == "done" and ckpt.latest_step(tmp_path) == 2
    assert all(np.isfinite(out["losses"]))
    assert "status=done step=2" in capsys.readouterr().out
