"""The port's musicgen_medium and nemotron_4_340b layers against the JAX
reference's.

The two configs need what the three earlier ones did not: LayerNorm
with its bias (`QNorm(kind="layer", use_bias=True)`), the ungated MLP
with GELU (musicgen) or squared ReLU (nemotron) behind its up GEMM,
MHA (24 kv heads, group 1 at hd 64) and GQA group 12 at hd 192.  On
the same inputs, made with numpy from a seed:

* the LayerNorm's integer `apply_id` equals the reference's at
  tolerance 0 at d 128, 1536, 2048 and 18432 (the centring shifts
  differ with d), its deploy leaf for leaf, its float forward within
  1e-5 of max |ref|;
* `QAct` RELU and RELU2 deploy the reference's tables and apply them at
  tolerance 0 (the requant kernel's act form in its plain version,
  also with a per-channel `rqt2`), the float activations within 1e-5;
* the ungated `QMLP` (GELU, RELU2, RELU): float forward within 1e-5
  with the same observations, deploy leaf for leaf, `apply_id` at
  tolerance 0; a down GEMM at nemotron's K 73728 whose accumulator
  passes 2^31 wraps as the reference's does;
* reduced musicgen_medium and nemotron_4_340b: the config values, the
  deploy leaf for leaf, the port's calibrate -> deploy -> engine
  against the reference's `deploy_model` -> engine (`paged=True,
  paged_kernel=False`) token for token at kv_bits 8 and 4, and the
  configs' real head geometry at narrow width (group 1 at hd 64, group
  12 at hd 192) on the engine;
* the paged attention's plain version at those head geometries against
  the reference's mirror, and its launch plan at hd 192;
* the CLI serves each reduced config on the CPU.
"""
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.intmath import apply_lut as j_apply_lut
from repro.core.requant import apply_rqt as j_apply_rqt, make_rqt as j_make_rqt
from repro.core.rep import Rep
from repro.kernels import ref
from repro.launch.serve import deploy_model as j_deploy_model
from repro.layers.act_quant import QAct as JQAct
from repro.layers.common import (
    ActKind as JActKind, DeployCtx as JDeployCtx, act_fn as j_act_fn,
)
from repro.layers.linear import QLinear as JQLinear
from repro.layers.mlp import QMLP as JQMLP
from repro.layers.norms import QNorm as JQNorm
from repro.models.blocks import DenseBlock as JDenseBlock
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.kernels import paged_attention, requant_act_plain
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (
    _SMEM_LIMIT, HEAD_DIMS, MMA_SHAPES, paged_plan, staged_unpack_rq,
)
from repro_torch.launch import serve as t_serve
from repro_torch.launch.serve import calibration_sample
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.attention import INACTIVE_POS
from repro_torch.layers.common import ActKind, DeployCtx, act_fn
from repro_torch.layers.linear import QLinear
from repro_torch.layers.mlp import QMLP
from repro_torch.layers.norms import QNorm, _center_shifts
from repro_torch.models.blocks import DenseBlock
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy, tree_to_torch,
)
from repro_torch.serving import SchedulerConfig, ServingConfig, ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("musicgen_medium", "nemotron_4_340b")
MAX_LEN = 64
TOL = 1e-5  # of max |ref| (float outputs) and of the span (ranges)


def _x(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(want, got, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = float(np.max(np.abs(want - got)))
    assert err <= TOL * float(np.max(np.abs(want))), (what, err)


def _same_ranges(jc, tc):
    assert list(tc.hi) == list(jc.hi)
    for name in jc.hi:
        span = max(jc.hi[name] - jc.lo[name], 1e-6)
        assert abs(tc.hi[name] - jc.hi[name]) <= TOL * span, name
        assert abs(tc.lo[name] - jc.lo[name]) <= TOL * span, name


def _compare(want, got, path="", seen=None):
    """Leaf for leaf: same keys, dtypes, shapes, values."""
    if isinstance(want, dict):
        assert not set(got) - set(want), f"{path}: port-only keys"
        for k, v in want.items():
            _compare(v, got[k], f"{path}/{k}", seen)
        return
    if isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _compare(a, b, f"{path}/{i}", seen)
        return
    a, b = np.asarray(want), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)
    if seen is not None:
        seen.append(path)


def _calibrators(names_ranges):
    """The same ranges in a reference and a port calibrator."""
    state = {"lo": {n: lo for n, (lo, _) in names_ranges.items()},
             "hi": {n: hi for n, (_, hi) in names_ranges.items()}}
    return JCalibrator.from_state(state), Calibrator.from_state(state)


# -- LayerNorm ----------------------------------------------------------------
def _norm_inputs(d, seed):
    """8 rows of int8: full range, a large mean offset, small amplitude,
    one sign, a constant row (sum of squares 0), a single spike, and two
    more full-range rows; gains and biases of both signs."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-128, 128, size=(8, d))
    s[1] = np.clip(rng.integers(-30, 31, size=d) + 90, -128, 127)
    s[2] = rng.integers(-3, 4, size=d)
    s[3] = rng.integers(0, 128, size=d)
    s[4] = 17
    s[5] = 0
    s[5, d // 3] = -128
    g = 1.0 + 0.3 * rng.standard_normal(d)
    b = 0.5 * rng.standard_normal(d)
    return s.astype(np.int8), {"g": g.astype(np.float32),
                               "b": b.astype(np.float32)}


@pytest.mark.parametrize("d", [128, 1536, 2048, 18432])
def test_layer_norm_apply_id_equals_reference(d):
    s, p = _norm_inputs(d, d)
    jc, tc = _calibrators({"S0.L0.n1.norm1": (-3.1, 2.7)})
    j = JQNorm(d, kind="layer", use_bias=True, name="norm1")
    t = QNorm(d, kind="layer", use_bias=True, name="norm1")
    jt, jeps, _ = j.deploy(JDeployCtx(calib=jc), "S0.L0.n1.", p, 0.05)
    tt, teps, _ = t.deploy(DeployCtx(calib=tc), "S0.L0.n1.", p, 0.05)
    _compare(jt, tt)
    assert teps == jeps and set(tt) == {"g_q", "m", "sh", "b_q"}
    want = np.asarray(j.apply_id(jt, jnp.asarray(s)))
    got = t.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the centring shifts differ with d (d 18432: c_bits 23, 15 and 0)
    assert _center_shifts(d) == {128: (3, 4), 1536: (9, 2), 2048: (9, 2),
                                 18432: (15, 0)}[d]


@pytest.mark.parametrize("d", [128, 1536, 2048, 18432])
def test_layer_norm_apply_fp_equals_reference(d):
    x = _x(d + 1, (2, 3, d), 2.0) + 0.7
    _, p = _norm_inputs(d, d)
    jc, tc = JCalibrator(), Calibrator()
    j = JQNorm(d, kind="layer", use_bias=True, name="norm2")
    t = QNorm(d, kind="layer", use_bias=True, name="norm2")
    want = j.apply_fp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), calib=jc, scope="s.")
    got = t.apply_fp(params_to_torch(p, "cpu"), torch.from_numpy(x), tc,
                     "s.")
    _close(want, got, "layer norm")
    _same_ranges(jc, tc)
    assert t.init_np().keys() == {"g", "b"}


# -- the activations ----------------------------------------------------------
@pytest.mark.parametrize("kind", ["relu", "relu2"])
def test_float_act_equals_reference(kind):
    x = _x(0, (4, 257), 4.0)
    _close(j_act_fn(JActKind(kind), jnp.asarray(x)),
           act_fn(ActKind(kind), torch.from_numpy(x)), kind)


# (kind, per-channel rqt2): the deploy makes rqt2 scalar; the last case
# hands the act form a per-channel one
ACT_CASES = [("relu", False), ("relu2", False), ("gelu", False),
             ("relu2", True)]


@pytest.mark.parametrize("kind,pc_rqt2", ACT_CASES,
                         ids=[f"{k}{'-pc_rqt2' if p else ''}"
                              for k, p in ACT_CASES])
def test_act_deploy_and_apply_id_equal_reference(kind, pc_rqt2):
    N = 96
    rng = np.random.default_rng(len(kind) + pc_rqt2)
    eps_in = rng.uniform(1e-5, 4e-5, size=N)
    jc, tc = _calibrators({"s.act": (-0.2, 5.3), "s.act.pre": (-4.0, 3.5)})
    j, t = JQAct(JActKind(kind), name="act"), QAct(ActKind(kind), name="act")
    jt, jeps, jzp = j.deploy(JDeployCtx(calib=jc), "s.", eps_in, 0,
                             float(512 * 127 * 127))
    tt, teps, tzp = t.deploy(DeployCtx(calib=tc), "s.", eps_in, 0,
                             float(512 * 127 * 127))
    _compare(jt, tt)
    assert (teps, tzp) == (jeps, jzp)
    if kind == "relu2":
        assert set(tt) == {"rqt", "rqt2"} and tt["rqt"]["zp"] == -128
    if pc_rqt2:
        eps2 = rng.uniform(0.5, 1.5, size=N) * (5.3 / 255 ** 2)
        jt = dict(jt, rqt2=j_make_rqt(eps2, 5.3 / 255, zp_out=-128,
                                      acc_bound=float(255 ** 2)))
        tt = dict(tt, rqt2=jax.tree.map(np.asarray, jt["rqt2"]))
        assert np.asarray(tt["rqt2"]["m"]).shape == (N,)
    acc = rng.integers(-(1 << 20), 1 << 20, size=(5, 7, N)).astype(np.int32)
    want = np.asarray(j.apply_id(jt, jnp.asarray(acc)))
    got = t.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(acc))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "relu":
        # the act form alone on the first requant's image
        s = rng.integers(-128, 128, size=(3, N)).astype(np.int8)
        if kind == "relu2":
            img = np.maximum(s.astype(np.int32) + 128, 0)
            want = np.asarray(j_apply_rqt(jnp.asarray(img * img),
                                          jt["rqt2"]))
        else:
            want = np.asarray(j_apply_lut(jnp.asarray(s),
                                          jnp.asarray(jt["lut"]), qmin=-128))
        got = requant_act_plain(torch.from_numpy(s), tree_to_torch(tt, "cpu"))
        np.testing.assert_array_equal(got.numpy(), want)


# -- the ungated MLP ----------------------------------------------------------
@pytest.mark.parametrize("act", ["gelu", "relu2", "relu"])
def test_ungated_mlp_equals_reference(act):
    """Float forward and observations, deploy from the reference's
    ranges leaf for leaf, apply_id at tolerance 0."""
    d, ff = 64, 192
    j = JQMLP(d, ff, act=JActKind(act), gated=False)
    t = QMLP(d, ff, act=ActKind(act), gated=False)
    p = j.init(jax.random.PRNGKey(len(act)))
    x = _x(len(act), (2, 9, d), 1.5)
    jc, tc = JCalibrator(), Calibrator()
    want = j.apply_float(p, jnp.asarray(x), Rep.FP, calib=jc, scope="S0.L1.")
    got = t.apply_float(params_to_torch(_np(p), "cpu"), torch.from_numpy(x),
                        tc, "S0.L1.")
    _close(want, got, "ungated mlp")
    _same_ranges(jc, tc)
    assert list(tc.hi) == ["S0.L1.mlp.act.pre", "S0.L1.mlp.act",
                           "S0.L1.mlp.h"]
    tc = Calibrator.from_state(jc.state_dict())
    jt, jeps = j.deploy(JDeployCtx(calib=jc), "S0.L1.", _np(p), 0.03, 0)
    tt, teps = t.deploy(DeployCtx(calib=tc), "S0.L1.", _np(p), 0.03, 0)
    seen = []
    _compare(_np(jt), tt, seen=seen)
    np.testing.assert_array_equal(teps, jeps)
    # two GEMMs (w_q, b_q each) and the activation's requant trees (6
    # leaves each), GELU's LUT
    assert set(tt) == {"wu", "u_tab", "wd"} and len(seen) == {
        "gelu": 11, "relu2": 16, "relu": 10}[act]
    s = np.random.default_rng(7).integers(-128, 128, size=(3, 5, d)).astype(
        np.int8)
    want = np.asarray(j.apply_id(jt, jnp.asarray(s)))
    got = t.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 3])
def test_down_gemm_at_nemotron_k_wraps_like_reference(rows):
    """K 73728 with the squared ReLU's zero point -128 folded into the
    bias: the exact accumulator passes 2^31 and must wrap in int32 as
    the reference's does."""
    K, N = 73728, 16
    rng = np.random.default_rng(rows)
    w = np.where(rng.random((K, N)) < 0.98, 1.0, -1.0) * rng.uniform(
        0.95, 1.0, size=(K, N))
    p = {"w": w.astype(np.float32)}
    j, t = JQLinear(K, N), QLinear(K, N)
    jt, _ = j.deploy(p, 0.01, -128)
    tt, _ = t.deploy(p, 0.01, -128)
    _compare(jt, tt)
    s = np.full((rows, K), 127, np.int8)
    s[0, ::7] = 120
    exact = s.astype(np.int64) @ np.asarray(jt["w_q"], np.int64) + np.asarray(
        jt["b_q"], np.int64)
    assert exact.max() >= 2 ** 31  # the wrap is exercised
    want = np.asarray(j.apply_id(jt, jnp.asarray(s)))
    got = t.apply_id(tree_to_torch(tt, "cpu"), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want.astype(np.int64), (exact + 2 ** 31) % 2 ** 32 - 2 ** 31)


# -- the block ----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_block_float_forward_equals_reference(arch):
    c = j_get_config(arch)
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4 if c.n_kv_heads ==
              c.n_heads else 2, head_dim=16, d_ff=128, gated=False,
              norm="layer", norm_bias=True, max_seq=64)
    j = JDenseBlock(act=JActKind(c.act), **kw)
    t = DenseBlock(act=ActKind(c.act), **kw)
    p = j.init(jax.random.PRNGKey(3))
    x = _x(3, (2, 11, 64), 0.5)
    jc, tc = JCalibrator(), Calibrator()
    want = j.apply_float(p, jnp.asarray(x), Rep.FP, calib=jc,
                         scope="S0.L0.")[0]
    got = t.apply_float(params_to_torch(_np(p), "cpu"), torch.from_numpy(x),
                        tc, "S0.L0.")
    _close(want, got, arch)
    _same_ranges(jc, tc)


# -- the reduced configs ------------------------------------------------------
def test_configs_equal_the_reference_values():
    assert set(ARCHS) < set(ARCH_IDS)
    for arch in ARCHS:
        got, want = get_config(arch), j_get_config(arch)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        r, jr = got.reduced(), want.reduced()
        for f in dataclasses.fields(r):
            assert getattr(r, f.name) == getattr(jr, f.name), f.name
        assert (r.d_model, r.n_heads, r.n_kv_heads, r.hd, r.d_ff) == (
            128, 4, 2, 32, 256)
    assert get_config("musicgen_medium").hd == 64
    assert get_config("nemotron_4_340b").hd == 192


_CACHE = {}


def _cut(cfg, geometry: bool):
    if not geometry:
        return cfg.reduced()
    # the real head geometry at narrow width: H and K cut in proportion
    # (musicgen MHA: 4/4 at hd 64; nemotron group 12: 24/2 at hd 192),
    # 1 layer, d 128, d_ff 256, vocab 256
    H, K = {"musicgen_medium": (4, 4), "nemotron_4_340b": (24, 2)}[cfg.name]
    return dataclasses.replace(cfg, n_layers=1, d_model=128, d_ff=256,
                               vocab=256, n_heads=H, n_kv_heads=K,
                               name=cfg.name + "_heads")


def _reference(arch, geometry=False):
    """(reference lm, params, its calibrator, its tables) as the
    reference's `deploy_model` builds them (PRNGKey(0), the entry
    point's sample)."""
    key = (arch, geometry)
    if key not in _CACHE:
        cfg = _cut(j_get_config(arch), geometry)
        lm = JLM(cfg, max_seq=MAX_LEN)
        p = lm.init(jax.random.PRNGKey(0))
        sample = calibration_sample(cfg.vocab, MAX_LEN)
        calib = lm.calibrate(p, jnp.asarray(sample))
        _CACHE[key] = (lm, p, calib, lm.deploy(p, calib), sample)
    return _CACHE[key]


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_deploy_equals_reference_leaf_for_leaf(arch, calibrated):
    jlm, p, calib, jt, _ = _reference(arch)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
    if calibrated:
        want = jt
        got = tlm.deploy(_np(p), Calibrator.from_state(calib.state_dict()))
    else:
        want, got = jlm.deploy(p, None), tlm.deploy(_np(p), None)
    seen = []
    _compare(_np(want), got, seen=seen)
    # the layer-stacked leaves: norm1 and norm2 (4 each with b_q), the
    # attention's 62 (its sm_tabs' 5 included), two Adds' 14 each, the ungated MLP's 11 (GELU) or
    # 16 (ReLU^2); then the embedding, the final norm's 4, the head's 2
    # and the 2 meta leaves
    mlp = 11 if arch == "musicgen_medium" else 16
    assert len(seen) == 8 + 62 + 28 + mlp + 1 + 4 + 2 + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_equals_reference(arch):
    jlm, p, jc, _, sample = _reference(arch)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
    tc = tlm.calibrate(_np(p), sample, device="cpu")
    _same_ranges(jc, tc)


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


def _engines(jlm, jt, tlm, tt, kv_bits, chunk=8):
    kw = dict(n_slots=3, max_len=MAX_LEN, page_size=8, kv_bits=kv_bits)
    j = JServingEngine(jlm, jt, JServingConfig(
        paged=True, paged_kernel=False,
        scheduler=JSchedulerConfig(prefill_chunk=chunk), **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        device="cpu", paged=True,
        scheduler=SchedulerConfig(prefill_chunk=chunk), **kw))
    return j, t


def _schedule(rqt):
    """The scales m / 2^d of a layer-stacked requant tree, (L, entries)."""
    d = np.asarray(rqt["d"], np.float64)
    m = np.asarray(rqt["m"], np.float64).reshape(d.shape[0], -1)
    return m * 2.0 ** -d[:, None]


def _on_rqt2_edge(want, got, path):
    """Where the two deploys differ at a squared ReLU's rqt2: its ratio
    eps_mid^2 / eps_y is 1/255 in exact arithmetic whatever the range,
    so at d 8 (m 1) the schedule's relative error is 1/256, the
    acceptance limit eta itself, and the float rounding of the
    calibrated range decides between (m 1, d 8) and (m 257, d 16).
    Both must be such schedules of 1/255: -> the leaf's path."""
    assert "/u_tab/rqt2/" in path, path
    for t in (want, got):
        sched = _schedule(t)
        err = np.abs(sched - 1 / 255) * 255
        assert np.all(err <= 1 / 256 + 1e-12), (path, sched)
    return path


def _differences(want, got, path=""):
    """Paths of the integer leaves that differ (rqt2 edges checked)."""
    out = []
    if isinstance(want, dict):
        if "/u_tab/rqt2" in path and "m" in want:
            if not all(np.array_equal(want[k], got[k]) for k in want):
                return [_on_rqt2_edge(want, got, path + "/")]
            return []
        for k, v in want.items():
            out += _differences(v, got[k], f"{path}/{k}")
        return out
    if isinstance(want, list):
        for i, (a, b) in enumerate(zip(want, got)):
            out += _differences(a, b, f"{path}/{i}")
        return out
    a, b = np.asarray(want), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=path)
    else:
        np.testing.assert_array_equal(b, a, err_msg=path)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_own_calibration_deploy_equals_reference(arch):
    """The port's calibrate -> deploy on the reference's params against
    the reference's calibrate -> deploy: every leaf equal (floats within
    rtol 1e-5) but a squared ReLU's rqt2 where its schedule sits on the
    acceptance edge (`_on_rqt2_edge`): there both deploys hold a valid
    schedule of the same ratio, and which one is the float rounding of
    the calibrated range (within 1e-5 of the span, and never bit-equal
    between torch and XLA).  On these params that is layer 1 of
    nemotron only."""
    jlm, p, jc, jt, sample = _reference(arch)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
    p_np = _np(p)
    got = tlm.deploy(p_np, tlm.calibrate(p_np, sample, device="cpu"))
    edges = _differences(_np(jt), got)
    assert edges == ([] if arch == "musicgen_medium" else
                     ["/segments/0/mlp/u_tab/rqt2/"])


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_engine_tokens_equal_reference(arch, kv_bits):
    """The port's deploy -> ServingEngine on the reference's params and
    calibrated ranges (carried across: the port's own calibration puts
    nemotron's rqt2 on the other side of its schedule edge, see
    `test_own_calibration_deploy_equals_reference`) against the
    reference's deploy_model -> ServingEngine(paged, gather oracle):
    same tokens, finish reasons, order and steps."""
    jlm, jt = j_deploy_model(arch, reduced=True, max_seq=MAX_LEN)
    _, p, jc, _, _ = _reference(arch)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(
        tlm.deploy(_np(p), Calibrator.from_state(jc.state_dict())),
        device="cpu")
    j, t = _engines(jlm, jt, tlm, tt, kv_bits)
    work = _work(tlm.cfg.vocab, kv_bits + len(arch))
    got = _drain(t, work)
    assert got == _drain(j, work)
    assert [len(toks) for _, toks, _ in got] == [6] * len(work)
    assert t.stats()["steps"] == j.stats()["steps"]


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_real_head_geometry_engine_tokens_equal_reference(arch, kv_bits):
    """The configs' own head shapes at narrow width: MHA at hd 64
    (musicgen, group 1) and GQA group 12 at hd 192 (nemotron), with
    their norms and activations; one table set carried across."""
    jlm, _, _, jt, _ = _reference(arch, geometry=True)
    tlm = DecoderLM(_cut(get_config(arch), True), max_seq=MAX_LEN)
    cfg = tlm.cfg
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == {
        "musicgen_medium": (1, 64), "nemotron_4_340b": (12, 192)}[arch]
    tt = tables_from_numpy(_np(jt), device="cpu")
    j, t = _engines(jlm, jt, tlm, tt, kv_bits, chunk=16)
    work = _work(cfg.vocab, 40 + kv_bits)
    assert _drain(t, work) == _drain(j, work)


# -- the paged attention at the new head geometries ---------------------------
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("K,group,hd", [(4, 1, 64), (2, 12, 192)])
def test_paged_attention_plain_equals_reference(K, group, hd, packed):
    rng = np.random.default_rng(group + packed)
    B, S, ps, pps, n_pages = 4, 3, 4, 4, 12
    H = K * group
    hd_store = hd // 2 if packed else hd
    q = rng.integers(-40, 41, size=(B, H, S, hd)).astype(np.int8)
    lo = -128 if packed else -40
    kp = rng.integers(lo, 41 if not packed else 128,
                      size=(n_pages + 1, K, ps, hd_store)).astype(np.int8)
    vp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd_store)).astype(
        np.int8)
    table = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 9],
                      [0, 0, 0, 0]], np.int32)
    pos = np.array([0, 6, 11, INACTIVE_POS], np.int32)
    scale = np.float32(1.0 / 512.0)
    kw, jkw = {}, {}
    if packed:
        k_rq = staged_unpack_rq(K)
        v_rq = torch.roll(k_rq, 1, dims=1)
        kw = dict(k_rq=k_rq, v_rq=v_rq)
        jkw = dict(k_rq=jnp.asarray(k_rq.numpy()),
                   v_rq=jnp.asarray(v_rq.numpy()))
    want = np.asarray(ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), score_scale=scale, group=group, **jkw))
    got = paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(pos), torch.tensor(scale),
        group=group, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S,pps", [(1, 32), (1, 256), (32, 32), (32, 256)])
def test_paged_plan_fits_at_hd_192(S, pps, packed):
    """nemotron's attention (8 slots, 8 kv heads, group 12, hd 192,
    pages of 16) at T 512 and 4096: a compiled launch within 220 KB.
    Decode over int8 pools with the scores recomputed (T 4096) fits no
    16-row ring and takes the 32-row launch; every other shape takes the
    rule of the narrower heads."""
    p = paged_plan(8, 8, 12, S, 192, 16, pps, packed)
    assert (p.warps, p.rows) in MMA_SHAPES and 2 <= p.stages <= 4
    assert p.smem <= _SMEM_LIMIT and p.smem >= 8 * 16 * 200 * 4
    assert p.blocks == 64 * -(-12 * S // p.rows)
    want_rows = 16 if S == 1 and (packed or pps == 32) else 32
    assert p.rows == want_rows
    assert p.logits == ("shared" if pps == 32 else "recomputed")


def test_head_dims_are_the_compiled_cases():
    """The wrapper's HEAD_DIMS (any other hd raises on the card) are
    exactly the widths the CUDA source's launch switch compiles."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    cases = tuple(int(v) for v in re.findall(r"PA_MMA_CASE\((\d+)\)\n",
                                              src))
    assert cases == HEAD_DIMS == (32, 64, 128, 192)


# -- the entry point ----------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_config_on_cpu(arch, capsys):
    t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--prompt-len", "12",
                  "--gen", "3", "--max-len", "24", "--paged",
                  "--page-size", "8", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert f"deployed {arch}_reduced (2 layers)" in out
    assert "drained 3 requests / 9 tokens" in out
