"""The paper's CNN in the port against the JAX reference: `NemoCNN`
through FP, FQ, QD and ID, and each module it adds (`core.rep`,
`core.bn`, `core.pact`'s forwards, the integer average pool,
`layers.conv`, `QLinear.apply_fq` and `harden_weights_np`).

The model is the reference pipeline test's: `NemoCNN(channels=(8, 16),
img=16)` on 8 images, the reference's `init` parameters carried across
with BN statistics drawn as that test draws them (`perturb_bn_np`), one
reference FullPrecision forward.  Held at tolerance 0 unless stated:

  - `deploy` from the reference's parameters and calibrator
    (`Calibrator.from_state`) equals the reference's tables leaf for
    leaf in fold, intbn and thresh at act_bits 8 and 4;
  - `apply_id` gives the reference's int32 logits and int8 activations
    after every block and every pool (the reference walked block by
    block with its own functions);
  - each new module alone: fold_bn, make_integer_bn (pre_shift 0 and
    > 0), apply_integer_bn, make_bn_act_thresholds (rounded and not),
    apply_thresholds (the binary search) and the reference's comparison
    count with repeated thresholds,
    int_avgpool_combine on negative sums, QConv2d.apply_id at zp -128
    and 0 (K 27 padded to 32 and K 72 to 80), QConv2d at stride 2 and 3
    and even kernels (FP / FQ within 1e-5, ID at zp 0, and VALID at
    zp -128), the zp-pad refusal the reference keeps, the PACT forwards;
  - FP and FQ logits within 1e-5 of max |ref|, the calibrator's ranges
    within 1e-5 of their span; QD logits within 1e-5, its activation
    quanta differing in at most 1 of 10^4 (a float32 on a floor
    boundary; the count is reported);
  - a deploy from the port's own calibration equal to the reference's;
  - integer only: every array of the deployed tree is integer (meta
    and IntegerBNParams.eps_out exempt, as in the reference's walk),
    every tensor of the device state too, and `apply_id` dispatches no
    op with a floating output outside `int8_matmul_plain` (whose
    float32 slices are exact; on the card it is the kernel).
"""
import dataclasses
import functools
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as j_get_config
from repro.core import bn as jbn
from repro.core import intmath as jintmath
from repro.core import pact as jpact
from repro.core import rep as jrep
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.requant import apply_rqt as j_apply_rqt
from repro.layers.conv import QAvgPool2d as JQAvgPool2d
from repro.layers.conv import QConv2d as JQConv2d
from repro.layers.conv import QMaxPool2d as JQMaxPool2d
from repro.layers.linear import QLinear as JQLinear
from repro.layers.linear import harden_weights_np as j_harden_weights_np
from repro.models.cnn import NemoCNN as JNemoCNN
from repro_torch.configs.base import (
    ARCH_IDS, LM_ARCH_IDS, SERVE_ARCH_IDS, get_config,
)
from repro_torch.core import bn, intmath, pact, rep
from repro_torch.core.calibrate import Calibrator
from repro_torch.layers.conv import QAvgPool2d, QConv2d, QMaxPool2d
from repro_torch.layers.linear import QLinear, harden_weights_np
from repro_torch.models.cnn import (
    NemoCNN, image_inputs, perturb_bn_np, tables_from_numpy,
)
from repro_torch.models.lm import DecoderLM, params_to_torch

MODES = ("fold", "intbn", "thresh")
KW = dict(channels=(8, 16), in_channels=3, n_classes=10, img=16)
TOL = 1e-5
RNG_SEED = 3


def _np(tree):
    """jax leaves -> numpy (jax treats IntegerBNParams as one leaf)."""
    return jax.tree.map(lambda a: a if dataclasses.is_dataclass(a)
                        else np.asarray(a), tree)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


# -- shared state: one reference init and one reference FP forward --------
@pytest.fixture(scope="module")
def ref():
    jm = JNemoCNN(**KW)
    rng = np.random.default_rng(RNG_SEED)
    p_np = perturb_bn_np(_np(jm.init(jax.random.PRNGKey(0))), rng)
    img = rng.integers(0, 256, size=(8, 16, 16, 3))
    x = jnp.asarray(img / 255.0, jnp.float32)
    jc = JCalibrator()
    y_fp = np.asarray(jm.apply_float(jax.tree.map(jnp.asarray, p_np), x,
                                     jrep.Rep.FP, calib=jc))
    xt, s_xt = image_inputs(img, "cpu")
    return dict(p_np=p_np, img=img, x=x, s_x=jnp.asarray(img - 128, jnp.int8),
                xt=xt, s_xt=s_xt, jc=jc, y_fp=y_fp,
                pt=params_to_torch(p_np, "cpu"))


@pytest.fixture(scope="module")
def deployed(ref):
    """(bits, mode) -> reference tables, port tables, the reference's
    per-block ID activations and logits, the port's (each deployed and
    run once)."""

    @functools.lru_cache(maxsize=None)
    def get(bits, mode):
        jm, m = JNemoCNN(**KW, act_bits=bits), NemoCNN(**KW, act_bits=bits)
        tj = jm.deploy(jax.tree.map(jnp.asarray, ref["p_np"]), ref["jc"],
                       bn_mode=mode)
        tp = m.deploy(ref["p_np"], Calibrator.from_state(
            ref["jc"].state_dict()), bn_mode=mode)
        j_logits = np.asarray(jm.apply_id(tj, ref["s_x"]))
        trace = []
        logits = m.apply_id(tables_from_numpy(tp, "cpu"), ref["s_xt"], trace)
        return tj, tp, _ref_id_walk(jm, tj, ref["s_x"]), j_logits, trace, \
            logits

    return get


def _ref_id_walk(jm, t, s_x):
    """The reference's `NemoCNN.apply_id`, block by block with its own
    functions, keeping each block's int8 output and each pool's."""
    pool, mode, trace = JQAvgPool2d(2), t["meta"]["bn_mode"], []
    for i, conv in enumerate(jm._convs()):
        blk = t["blocks"][i]
        acc = conv.apply_id(blk["conv"], s_x)
        if mode == "fold":
            s_y = j_apply_rqt(acc, blk["rqt"])
        elif mode == "intbn":
            s_y = j_apply_rqt(jbn.apply_integer_bn(acc, blk["ibn"]),
                              blk["rqt"])
        else:
            s_y = (jbn.apply_thresholds(acc, blk["th"]) - 128).astype(
                jnp.int8)
        s_x = pool.apply_id(s_y)
        trace += [np.asarray(s_y), np.asarray(s_x)]
    return trace


def _leaves_equal(a, b, path=""):
    """Reference table tree == port table tree, leaf for leaf, dtypes
    included (IntegerBNParams field by field)."""
    if dataclasses.is_dataclass(a):
        assert type(b).__name__ == type(a).__name__, path
        for f in dataclasses.fields(a):
            _leaves_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _leaves_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, bool)) or a is None:
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (
            path, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), path


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= tol, err


# -- configuration and representations ------------------------------------
def test_config_equals_the_reference_and_stays_off_the_lm_paths():
    got, want = get_config("nemo_cnn"), j_get_config("nemo_cnn")
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert "nemo_cnn" in ARCH_IDS and "nemo_cnn" not in LM_ARCH_IDS
    assert "nemo_cnn" not in SERVE_ARCH_IDS
    with pytest.raises(NotImplementedError, match="NemoCNN"):
        DecoderLM(got)
    from repro_torch.launch import serve

    assert 'choices=SERVE_ARCH_IDS' in inspect.getsource(serve.main)


def test_rep_equals_the_reference():
    assert [r.value for r in rep.PIPELINE] == [r.value for r in
                                               jrep.PIPELINE]
    for r, jr in zip(rep.Rep, jrep.Rep):
        assert (r.name, r.value, r.is_integer, r.is_quantized) == (
            jr.name, jr.value, jr.is_integer, jr.is_quantized)


# -- core.bn ---------------------------------------------------------------
def _bn_stats(rng, C):
    return (0.7 + 0.6 * rng.random(C), rng.normal(size=C) * 0.1,
            rng.normal(size=C) * 0.05, 1.0 + 0.3 * rng.random(C))


@pytest.mark.parametrize("bias", [False, True])
def test_fold_bn_equals_reference(bias):
    rng = np.random.default_rng(10 + bias)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32) if bias else None
    stats = [s.astype(np.float32) for s in _bn_stats(rng, 6)]
    want = jbn.fold_bn(w, b, *stats, channel_axis=-1)
    got = bn.fold_bn(w, b, *stats, channel_axis=-1)
    for a, g in zip(want, got):
        _leaves_equal(a, g)


@pytest.mark.parametrize("acc_bound", [float(1 << 22), 2.0 ** 30])
def test_make_integer_bn_equals_reference(acc_bound):
    """pre_shift 0 at the default bound, > 0 at 2^30."""
    rng = np.random.default_rng(int(acc_bound) % 97)
    stats = _bn_stats(rng, 16)
    eps_phi = rng.uniform(1e-6, 1e-5, size=16)
    want = jbn.make_integer_bn(*stats, eps_phi, acc_bound=acc_bound)
    got = bn.make_integer_bn(*stats, eps_phi, acc_bound=acc_bound)
    assert (got.pre_shift > 0) == (acc_bound > 2 ** 23)
    _leaves_equal(want, got)


@pytest.mark.parametrize("acc_bound", [float(1 << 22), 2.0 ** 30])
def test_apply_integer_bn_equals_reference(acc_bound):
    rng = np.random.default_rng(5)
    p = bn.make_integer_bn(*_bn_stats(rng, 16), rng.uniform(
        1e-6, 1e-5, size=16), acc_bound=acc_bound)
    q = rng.integers(-(1 << 30), 1 << 30, size=(4, 5, 16)).astype(np.int32)
    q[0, 0] = [-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 7, -7] + [3] * 9
    want = np.asarray(jbn.apply_integer_bn(jnp.asarray(q), p))
    got = bn.apply_integer_bn(_t(q), bn.integer_bn_to_torch(p, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounded", [False, True])
def test_make_bn_act_thresholds_equals_reference(rounded):
    rng = np.random.default_rng(7)
    stats = _bn_stats(rng, 12)
    for levels in (16, 256):
        want = jbn.make_bn_act_thresholds(*stats, 3e-6, 6.0 / (levels - 1),
                                          levels, rounded=rounded)
        got = bn.make_bn_act_thresholds(*stats, 3e-6, 6.0 / (levels - 1),
                                        levels, rounded=rounded)
        _leaves_equal(want, got)
    bad = (np.array([1.0, -1.0]),) + tuple(s[:2] for s in stats[1:])
    with pytest.raises(ValueError, match="gamma, sigma > 0"):
        bn.make_bn_act_thresholds(*bad, 1e-5, 0.1, 16)


def test_apply_thresholds_both_forms_with_repeated_thresholds():
    """The binary search (`apply_thresholds`) and the blocked comparison
    count equal the reference's count, with runs of repeated
    thresholds, values on, between and outside them; the blocked count
    crosses its block edge."""
    rng = np.random.default_rng(11)
    C, L = 6, 255
    th = np.sort(rng.integers(-3000, 3000, size=(C, L)), axis=1)
    th[0] = 17                                  # one threshold, L times
    th[1, 100:200] = th[1, 100]                 # a long run
    th[2] = np.sort(rng.integers(-20, 20, size=L))  # every value repeated
    q = rng.integers(-3500, 3500, size=(3, 7, 41, C))
    q[0, 0, :, 2] = np.arange(-20, 21)          # on, between and off
    q[1, 0, 0] = th[:, 0]                       # on TH_1
    q[1, 0, 1] = th[:, -1]                      # on the last
    q[1, 0, 2] = th[:, 150]                     # inside the runs
    q[1, 0, 3] = th[:, 0] - 1                   # just below
    want = np.asarray(jbn.apply_thresholds(jnp.asarray(q, jnp.int32), th))
    tt = bn.thresholds_to_torch(th, "cpu")
    qt = _t(q, np.int32)
    old = bn._COUNT_BLOCK
    try:
        bn._COUNT_BLOCK = 5 * C * L  # 5 rows a block, ragged last block
        count = bn.threshold_count(qt, tt)
    finally:
        bn._COUNT_BLOCK = old
    for got in (count, bn.apply_thresholds(qt, tt)):
        assert got.dtype == torch.int32 and got.shape == qt.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == L  # counts at both ends too


def test_thresholds_cast_like_the_reference_and_refuse_unsorted_rows():
    th = np.array([[-5, 0, 2 ** 31 + 3], [1, 1, 2]], np.int64)
    with pytest.raises(ValueError, match="non-decreasing"):
        bn.thresholds_to_torch(th, "cpu")  # 2^31 + 3 wraps negative
    th[0, 2] = 9
    t = bn.thresholds_to_torch(th, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        jnp.asarray(th, jnp.int32)))


def test_int_avgpool_combine_on_negative_sums():
    """Every 4-window int32 sum of int8 values, negative ones included,
    and a wider range at other d."""
    acc = np.arange(-512, 509, dtype=np.int32)
    for k_total, d in ((4, 15), (4, 8), (9, 15)):
        m, dd = intmath.avgpool_requant_params(k_total, d)
        assert (m, dd) == jintmath.avgpool_requant_params(k_total, d)
        want = np.asarray(jintmath.int_avgpool_combine(jnp.asarray(acc),
                                                       m, dd))
        got = intmath.int_avgpool_combine(_t(acc), m, dd)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    s = np.random.default_rng(2).integers(-128, 128, size=(3, 8, 6, 5))
    want = np.asarray(JQAvgPool2d(2).apply_id(jnp.asarray(s, jnp.int8)))
    got = QAvgPool2d(2).apply_id(_t(s, np.int8))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pools_float_and_max_equal_reference():
    x = np.random.default_rng(4).normal(size=(2, 8, 6, 3)).astype(np.float32)
    _close(JQAvgPool2d(2).apply_fp(jnp.asarray(x)),
           QAvgPool2d(2).apply_fp(_t(x)), 1e-7)
    for a in (x, np.round(x * 50).astype(np.int8)):
        np.testing.assert_array_equal(
            QMaxPool2d(2).apply(_t(a)).numpy(),
            np.asarray(JQMaxPool2d(2).apply(jnp.asarray(a))))


# -- layers.conv -------------------------------------------------------------
@pytest.mark.parametrize("zp", [-128, 0])
@pytest.mark.parametrize("c_in,c_out", [(3, 16), (8, 12)])
def test_conv_apply_id_equals_reference(zp, c_in, c_out):
    """SAME padding with the zero point in the ring (zp -128) and the
    reference's plain SAME branch (zp 0); K 27 padded to 32 and K 72 to
    80 in the device layout (zero weight rows, zero columns)."""
    rng = np.random.default_rng(c_in * 100 + (zp == 0))
    jc = JQConv2d(c_in, c_out)
    p = _np(jc.init(jax.random.PRNGKey(c_in)))
    ip, eps_acc = jc.deploy(p, 0.02, zp)
    conv = QConv2d(c_in, c_out)
    ip_p, eps_p = conv.deploy(p, 0.02, zp)
    _leaves_equal(ip, ip_p)
    _leaves_equal(eps_acc, eps_p)
    s = rng.integers(-128, 128, size=(2, 9, 7, c_in))
    want = np.asarray(jc.apply_id(jax.tree.map(jnp.asarray, ip),
                                  jnp.asarray(s, jnp.int8)))
    dev = conv.load(ip_p, "cpu")
    k_pad = -(-9 * c_in // 16) * 16
    assert dev["w_q"].shape == (k_pad, c_out)
    assert dev["w_q"].stride() == (1, k_pad)
    assert not dev["w_q"][9 * c_in:].any()
    got = conv.apply_id(dev, _t(s, np.int8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_float_forwards_and_refusals():
    rng = np.random.default_rng(8)
    jc = JQConv2d(5, 7, use_bias=True)
    p = _np(jc.init(jax.random.PRNGKey(1)))
    p["b"] = rng.normal(size=7).astype(np.float32)
    x = rng.normal(size=(2, 6, 5, 5)).astype(np.float32)
    conv, pt = QConv2d(5, 7, use_bias=True), params_to_torch(p, "cpu")
    _close(jc.apply_fp(p, jnp.asarray(x)), conv.apply_fp(pt, _t(x)))
    _close(jc.apply_fq(p, jnp.asarray(x)), conv.apply_fq(pt, _t(x)))
    # what the reference still refuses: a zero point in an asymmetric
    # SAME ring (stride 2, or an even kernel), the same error in both
    s = rng.integers(-128, 128, size=(2, 6, 5, 5))
    for kw in (dict(stride=2), dict(kernel=2)):
        jb, bad = JQConv2d(5, 7, **kw), QConv2d(5, 7, **kw)
        pb = _np(jb.init(jax.random.PRNGKey(2)))
        ip, _ = jb.deploy(pb, 0.02, -128)
        with pytest.raises(NotImplementedError) as want:
            jb.apply_id(jax.tree.map(jnp.asarray, ip),
                        jnp.asarray(s, jnp.int8))
        with pytest.raises(NotImplementedError) as got:
            bad.apply_id(bad.load(bad.deploy(pb, 0.02, -128)[0], "cpu"),
                         _t(s, np.int8))
        assert str(got.value) == str(want.value)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(ValueError, match="highest"):
            conv.apply_fp(pt, _t(x))
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("stride,kernel,padding", [
    (2, 3, "SAME"), (2, 2, "SAME"), (1, 2, "SAME"), (2, 3, "VALID"),
    (2, 2, "VALID"), (3, 4, "SAME")])
def test_strided_and_even_kernel_conv_equals_reference(stride, kernel,
                                                       padding):
    """Any stride and kernel, XLA's SAME rule (an odd input pads one more
    on the high side): FP and FQ within 1e-5 of max |ref|; the ID path
    at tolerance 0 with zp 0 (and, under VALID, zp -128, which no ring
    reads)."""
    rng = np.random.default_rng(stride * 10 + kernel)
    kw = dict(kernel=kernel, stride=stride, padding=padding)
    jc, conv = JQConv2d(8, 12, use_bias=True, **kw), QConv2d(
        8, 12, use_bias=True, **kw)
    p = _np(jc.init(jax.random.PRNGKey(kernel)))
    p["b"] = rng.normal(size=12).astype(np.float32)
    x = rng.normal(size=(2, 9, 7, 8)).astype(np.float32)
    pt = params_to_torch(p, "cpu")
    want = jc.apply_fp(p, jnp.asarray(x))
    got = conv.apply_fp(pt, _t(x))
    assert tuple(got.shape) == want.shape
    _close(want, got)
    _close(jc.apply_fq(p, jnp.asarray(x)), conv.apply_fq(pt, _t(x)))
    s = rng.integers(-128, 128, size=(2, 9, 7, 8))
    for zp in ((0, -128) if padding == "VALID" else (0,)):
        ip, _ = jc.deploy(p, 0.02, zp)
        ip_p, _ = conv.deploy(p, 0.02, zp)
        _leaves_equal(ip, ip_p)
        want = np.asarray(jc.apply_id(jax.tree.map(jnp.asarray, ip),
                                      jnp.asarray(s, jnp.int8)))
        got = conv.apply_id(conv.load(ip_p, "cpu"), _t(s, np.int8))
        np.testing.assert_array_equal(got.numpy(), want)


# -- core.pact forwards, QLinear ---------------------------------------------
def test_pact_forwards_equal_reference():
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(4, 33)) * 3).astype(np.float32)
    for bits in (4, 8):
        want = np.asarray(jpact.pact_act(jnp.asarray(x), jnp.float32(2.5),
                                         bits))
        got = pact.pact_act(_t(x), np.float32(2.5), bits)
        np.testing.assert_array_equal(got.numpy(), want)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    beta = pact.default_weight_beta(_t(w), -1)
    np.testing.assert_array_equal(
        beta.numpy(), np.asarray(jpact.default_weight_beta(jnp.asarray(w))))
    for b in (beta, beta.max()):
        want = np.asarray(jpact.pact_weight(jnp.asarray(w),
                                            jnp.asarray(b.numpy()), 8, -1))
        np.testing.assert_array_equal(pact.pact_weight(_t(w), b, 8).numpy(),
                                      want)
    # the straight-through gradients: dx passes on [0, beta), dbeta sums
    # the gradient above beta, dw passes on [-b, b) and beta_w gets none
    xt, bt = _t(x).requires_grad_(), torch.tensor(2.5, requires_grad=True)
    dx, db = torch.autograd.grad(pact.pact_act(xt, bt, 8).sum(), (xt, bt))
    np.testing.assert_array_equal(dx.numpy(), ((x >= 0) & (x < 2.5)) * 1.0)
    assert float(db) == float((x >= 2.5).sum())
    wt, bw = _t(w).requires_grad_(), beta.clone().requires_grad_()
    dw, dbw = torch.autograd.grad(pact.pact_weight(wt, bw, 8).sum(),
                                  (wt, bw))
    b = beta.numpy()
    np.testing.assert_array_equal(dw.numpy(), ((w >= -b) & (w < b)) * 1.0)
    assert not dbw.any()


def test_qlinear_fq_and_harden_equal_reference():
    jl, lin = JQLinear(48, 20, use_bias=True), QLinear(48, 20, use_bias=True)
    p = _np(jl.init(jax.random.PRNGKey(2)))
    p["b"] = np.linspace(-1, 1, 20).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(6, 48)).astype(np.float32)
    pt = params_to_torch(p, "cpu")
    _close(jl.apply_fq(p, jnp.asarray(x)), lin.apply(pt, _t(x), rep.Rep.FQ))
    _close(jl.apply_fp(p, jnp.asarray(x)), lin.apply(pt, _t(x), rep.Rep.QD))
    _leaves_equal(j_harden_weights_np(p), harden_weights_np(p))
    _leaves_equal(j_harden_weights_np(p, 4), harden_weights_np(p, 4))


# -- the model ---------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", MODES)
def test_deploy_equals_reference_leaf_for_leaf(deployed, bits, mode):
    tj, tp = deployed(bits, mode)[:2]
    _leaves_equal(_np(tj), tp)
    if mode == "thresh":
        assert all(b["th"].shape[-1] == 2 ** bits - 1 for b in tp["blocks"])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", MODES)
def test_apply_id_equals_reference(ref, deployed, bits, mode):
    """int32 logits and every block's and pool's int8 activations."""
    tj, tp, j_trace, _, trace, logits = deployed(bits, mode)
    want = np.asarray(JNemoCNN(**KW, act_bits=bits).apply_id(tj, ref["s_x"]))
    assert logits.dtype == torch.int32
    np.testing.assert_array_equal(logits.numpy(), want)
    assert len(trace) == len(j_trace) == 4
    for i, (w, g) in enumerate(zip(j_trace, trace)):
        assert g.dtype == torch.int8, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))


def test_fp_and_fq_forwards_and_ranges_close(ref):
    """FP logits and the calibrator's ranges (the port's own forward on
    the same params), then FQ at each act_bits on the reference's betas."""
    tc = Calibrator()
    got = NemoCNN(**KW).apply_float(ref["pt"], ref["xt"], rep.Rep.FP,
                                    calib=tc)
    _close(ref["y_fp"], got)
    jc = ref["jc"]
    assert set(tc.hi) == set(jc.hi) == {"b0.phi", "b0.act", "b1.phi",
                                        "b1.act"}
    for k in jc.hi:
        span = jc.hi[k] - jc.lo[k]
        assert abs(tc.hi[k] - jc.hi[k]) <= TOL * span, k
        assert abs(tc.lo[k] - jc.lo[k]) <= TOL * span, k
    own = NemoCNN(**KW).calibrate(ref["p_np"], ref["xt"], device="cpu")
    assert own.state_dict() == tc.state_dict()
    for bits in (8, 4):
        betas = [np.float32(jc.beta(f"b{i}.act")) for i in range(2)]
        want = JNemoCNN(**KW, act_bits=bits).apply_float(
            jax.tree.map(jnp.asarray, ref["p_np"]), ref["x"], jrep.Rep.FQ,
            qstate={"beta": [jnp.float32(b) for b in betas]})
        got = NemoCNN(**KW, act_bits=bits).apply_float(
            ref["pt"], ref["xt"], rep.Rep.FQ, qstate={"beta": betas})
        _close(want, got)


def test_qd_forward_close(ref):
    """harden and qd_state equal the reference's; apply_qd within 1e-5,
    its activation quanta equal but where a float32 sits on a floor
    boundary (at most 1 in 10^4)."""
    jm, m = JNemoCNN(**KW), NemoCNN(**KW)
    jp = jax.tree.map(jnp.asarray, ref["p_np"])
    hard_j, hard = _np(jm.harden(jp)), m.harden(ref["p_np"])
    _leaves_equal(hard_j, hard)
    cal = Calibrator.from_state(ref["jc"].state_dict())
    ds_j, ds = _np(jm.qd_state(jp, ref["jc"])), m.qd_state(ref["p_np"], cal)
    _leaves_equal(ds_j, ds)
    want = np.asarray(jm.apply_qd(jax.tree.map(jnp.asarray, hard_j), ds_j,
                                  ref["x"]))
    trace = []
    got = m.apply_qd(params_to_torch(hard, "cpu"), ds, ref["xt"], trace)
    _close(want, got)
    # the reference's quanta, block by block on its own inputs
    x, pool, moved, total = ref["x"], JQAvgPool2d(2), 0, 0
    for i, conv in enumerate(jm._convs()):
        d = ds_j["blocks"][i]
        bnv = conv.apply_fp(jax.tree.map(jnp.asarray, hard_j["blocks"][i][
            "conv"]), x) * d["kappa_hat"] + d["lambda_hat"]
        q = jnp.clip(jnp.floor(bnv / d["eps_y"]), 0, 255)
        x = pool.apply_fp(q * d["eps_y"])
        moved += int((np.asarray(q) != trace[i].numpy()).sum())
        total += q.size
    print(f"QD activation quanta moved: {moved} of {total}")
    assert moved * 10 ** 4 <= total, (moved, total)


def test_own_calibration_deploy_equals_reference(ref, deployed):
    """A deploy from the port's own FP forward's ranges gives the
    reference's tables in every mode (the ranges come out equal here)."""
    own = NemoCNN(**KW).calibrate(ref["p_np"], ref["xt"], device="cpu")
    for bits in (8, 4):
        for mode in MODES:
            tp = NemoCNN(**KW, act_bits=bits).deploy(ref["p_np"], own,
                                                     bn_mode=mode)
            _leaves_equal(_np(deployed(bits, mode)[0]), tp)


def _integer_walk(tree, path=""):
    if isinstance(tree, bn.IntegerBNParams):
        for f in ("q_kappa", "q_lambda"):  # eps_out is transform-time
            _integer_walk(getattr(tree, f), path + "." + f)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != "meta":
                _integer_walk(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _integer_walk(v, f"{path}[{i}]")
    elif isinstance(tree, np.ndarray):
        assert np.issubdtype(tree.dtype, np.integer), (path, tree.dtype)
    elif isinstance(tree, torch.Tensor):
        assert not tree.is_floating_point(), (path, tree.dtype)
    else:
        assert isinstance(tree, (int, np.integer)), (path, type(tree))


class _FloatOutputs(TorchDispatchMode):
    """Records every op whose output is floating, outside the spans
    marked exempt."""

    def __init__(self):
        super().__init__()
        self.ops, self.exempt, self.seen = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen += 1
        if not self.exempt and any(
                isinstance(o, torch.Tensor) and o.is_floating_point()
                for o in _pytree.tree_leaves(out)):
            self.ops.append(str(func))
        return out


@pytest.mark.parametrize("mode", MODES)
def test_id_integer_only(ref, deployed, monkeypatch, mode):
    """Claim (5) of the reference's pipeline test, for the port."""
    tp = deployed(8, mode)[1]
    _integer_walk(tp)
    t = tables_from_numpy(tp, "cpu")
    _integer_walk(t)
    gemm = sys.modules["repro_torch.kernels.int8_matmul"]
    plain, mode_ = gemm.int8_matmul_plain, _FloatOutputs()

    def exempt_plain(*a, **kw):
        mode_.exempt += 1
        try:
            return plain(*a, **kw)
        finally:
            mode_.exempt -= 1

    monkeypatch.setattr(gemm, "int8_matmul_plain", exempt_plain)
    with mode_:
        logits = NemoCNN(**KW).apply_id(t, ref["s_xt"])
    assert mode_.seen > 20 and not mode_.ops, mode_.ops
    np.testing.assert_array_equal(logits.numpy(), deployed(8, mode)[5])


def test_tables_from_numpy_layout(deployed):
    tp = deployed(8, "intbn")[1]
    t = tables_from_numpy(tp, "cpu")
    assert t["meta"] == tp["meta"]
    w0 = t["blocks"][0]["conv"]["w_q"]
    assert w0.shape == (32, 8) and w0.stride() == (1, 32)
    np.testing.assert_array_equal(w0[:27].numpy(),
                                  tp["blocks"][0]["conv"]["w_q"].reshape(27, 8))
    assert t["blocks"][0]["conv"]["zp_in"] == -128
    ibn = t["blocks"][1]["ibn"]
    assert ibn["q_kappa"].dtype == torch.int32
    assert ibn["pre_shift"] == tp["blocks"][1]["ibn"].pre_shift
    head = t["head"]["w_q"]
    assert head.shape == (256, 10) and head.stride() == (1, 256)
    th = tables_from_numpy(deployed(4, "thresh")[1], "cpu")["blocks"][0]["th"]
    assert th.dtype == torch.int32 and th.shape == (8, 15)
