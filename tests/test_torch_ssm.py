"""The ssm family in the port against the JAX reference: the scan
island's fixed float32 sequences, `QMamba1`, `MambaBlock`, reduced
falcon_mamba_7b end to end.

Held at tolerance 0 unless stated:

  - `core.island`'s exp, log, log1p and softplus against `jnp.exp`,
    `jnp.log`, `jnp.log1p` and `jax.nn.softplus` bit for bit on sweeps
    of their domains; the associative scan and the scan core
    (`ssm_core`: one block, and chunks at L a multiple of 128, with and
    without a state) against the reference's under `jax.jit`: y and h
    bit for bit (bit equality is not built in, since XLA picks what it
    fuses into multiply-adds; the counts of differing bits are the
    assertion);
  - the integer causal conv1d over a cached window;
  - the reference's calibration of reduced falcon_mamba_7b within 1e-5
    of the span in the port's float forward, the whole deploy leaf for
    leaf from the reference's ranges (float leaves within rtol 1e-5),
    from the port's own ranges with boundary multipliers counted;
    `deploy_model`'s layer-by-layer tables equal the whole-tree deploy;
  - `QMamba1.apply_id` at the chunk boundaries (L 127, 128, 200, 256)
    with and without a cached state: out_proj's int32 accumulator, the
    conv window, h bit for bit; the s_y images that differ and the h
    entries that are not bit-equal counted (0 asserted);
  - a prefill then decode steps of the whole model: logits and both
    state leaves;
  - the engine in exact mode, lockstep with the reference engine over
    `SlotArena` and the paged arena (`paged_kernel=False`) at dispatch
    depth 0 and 1 and under a scripted preemption: tokens, finish
    reasons, steps, arena host state after every step, and the arena's
    conv and h state after the drain;
  - the reference's refusals (kv_bits 4, the prefix cache), the
    integer-cache check, and the variants `ssm_chunk` and the bf16
    island (`tests/test_torch_ssm_bf16.py` holds the bf16 island's
    layers and engines).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.rep import Rep
from repro.launch import variants as j_variants
from repro.layers.ssm import (
    QMamba1 as JQMamba1, _assoc_scan as j_assoc_scan,
    _causal_conv1d_int as j_causal_conv1d_int,
)
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro.serving.cache import (
    assert_integer_caches as j_assert_integer_caches,
)
from repro_torch.configs.base import get_config
from repro_torch.core.island import (
    exp_f32, ftz, log1p_f32, log_f32, softplus_f32,
)
from repro_torch.launch import variants
from repro_torch.launch.serve import (
    calibration_sample, deploy_model, main as serve_main,
)
from repro_torch.layers.ssm import (
    QMamba1, _scan, causal_conv1d_int, load_core, ssm_core,
)
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy, tree_to_torch,
)
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine, SlotArena,
)
from repro_torch.serving.cache import assert_integer_caches
from test_policy import ScriptedPreemptions
from test_torch_moe import _deploy_diff

TOL = 1e-5  # of the reference's span (ranges) and of max |ref| (floats)
ARCH = "falcon_mamba_7b"
MAX_LEN = 256
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's scan island is thousands of small torch ops; beside
    the suite's other workers, intra-op threads only contend for the
    cores, so this module runs torch on one thread (restored after)."""
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
def _sweep(fn):
    rng = np.random.default_rng(7)
    n = 200_000
    if fn == "exp":
        x = np.concatenate([-rng.uniform(0, 110, n), [0.0, -0.0, -87.3,
                                                      -87.8, -200.0]])
    elif fn == "log":
        x = np.exp(rng.uniform(-80, 80, n))
    elif fn == "log1p":
        x = np.concatenate([rng.uniform(0, 1, n // 2),
                            np.exp(-rng.uniform(0, 80, n // 2)),
                            [0.0, 1.0, 0.41421354, 0.41421357]])
    else:
        x = np.concatenate([rng.standard_normal(n // 2) * 5,
                            rng.uniform(-100, 100, n // 2), [0.0, -0.0]])
    return x.astype(F32)


ISLAND = {"exp": (exp_f32, jnp.exp), "log": (log_f32, jnp.log),
          "log1p": (log1p_f32, jnp.log1p),
          "softplus": (softplus_f32, jax.nn.softplus)}


@pytest.mark.parametrize("fn", sorted(ISLAND))
def test_island_function_equals_reference(fn):
    """Each fixed float32 sequence gives XLA's bits on every input of
    the sweep."""
    ours, ref = ISLAND[fn]
    x = _sweep(fn)
    got = ours(torch.from_numpy(x)).numpy()
    assert _bits_differ(got, jax.jit(ref)(x)) == 0


def test_ftz_keeps_the_sign_of_a_flushed_zero():
    x = torch.tensor([1e-39, -1e-39, 1.2e-38, -3.0, 0.0], dtype=torch.float32)
    got = ftz(x)
    assert got.tolist()[2:] == x.tolist()[2:]
    assert got[0] == 0 and got[1] == 0
    assert not torch.signbit(got[0]) and torch.signbit(got[1])


def _scan_inputs(L, seed, B=2, di=32, ds=16, dt_scale=3.0):
    """Seeded scan inputs shaped like the island's: x1 and B images with
    zeros, dt softplus'd (large enough that decay products go
    subnormal), integer C images."""
    rng = np.random.default_rng(seed)
    x1 = (rng.integers(-128, 128, (B, L, di))
          * (rng.random((B, L, di)) < 0.5) * 0.02).astype(F32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, di))))
          * dt_scale).astype(F32)
    bm = (rng.integers(-128, 128, (B, L, ds))
          * (rng.random((B, L, ds)) < 0.5) * 0.03).astype(F32)
    cm = (rng.integers(-128, 128, (B, L, ds)) * 0.03).astype(F32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=F32), (di, ds)).copy()
    D = np.ones(di, F32)
    h0 = rng.standard_normal((B, di, ds)).astype(F32)
    return x1, dt, bm, cm, A, D, h0


@pytest.mark.parametrize("L", [2, 3, 8, 13])
def test_associative_scan_recursion_equals_reference(L):
    """The odd / even recursion of `jax.lax.associative_scan` over the
    (a, u) pairs (inputs flushed of subnormals, as the island's are)."""
    x1, dt, bm, _, A, _, _ = _scan_inputs(L, L)
    a = ftz(torch.from_numpy(np.exp(dt[..., None] * A).astype(F32))).numpy()
    u = ftz(torch.from_numpy((dt[..., None] * bm[..., None, :]
                              * x1[..., None]).astype(F32))).numpy()
    ref = jax.jit(lambda a, u: j_assoc_scan(a, u))(a, u)
    got = _scan(torch.from_numpy(a), torch.from_numpy(u))[1]
    assert _bits_differ(got.numpy(), ref) == 0


@pytest.mark.parametrize("L,h0", [(5, False), (40, True), (127, True),
                                  (128, False), (200, True), (256, True)])
def test_ssm_core_equals_reference(L, h0):
    """`ssm_core` against the reference's `QMamba1._core_fp` under jit:
    one block below or off a chunk multiple, chunks of 128 on it; y
    and the last state bit for bit."""
    x1, dt, bm, cm, A, D, hs = _scan_inputs(L, 100 + L)
    hs = hs if h0 else None
    m = JQMamba1(16, d_state=16)
    jy, jh = jax.jit(lambda *a: m._core_fp(*a, return_h=True))(
        x1, dt, bm, cm, A, D, hs)
    T = torch.from_numpy
    y, h = ssm_core(T(x1), T(dt), T(bm), T(cm), T(A), T(D),
                    h0=None if hs is None else T(hs))
    assert (_bits_differ(y.numpy(), jy), _bits_differ(h.numpy(), jh)) == (
        0, 0)


def test_ssm_chunk_variant_and_bf16_island():
    """`ssm_chunk` 64 runs 128 positions as two chunks in both packages
    (equal bits); with the bf16 island too (each chunk's scan in
    bfloat16, the carry in float32), y and h equal the reference's bit
    for bit and differ from the float32 island's."""
    x1, dt, bm, cm, A, D, h0 = _scan_inputs(128, 3)
    m = JQMamba1(16, d_state=16)
    T = torch.from_numpy
    args = (T(x1), T(dt), T(bm), T(cm), T(A), T(D))
    for kw in ({}, {"ssm_island_dtype": "bf16"}):
        with j_variants.use_variants(ssm_chunk=64, **kw):
            jy, jh = jax.jit(lambda *a: m._core_fp(*a, return_h=True))(
                x1, dt, bm, cm, A, D, h0)
        with variants.use_variants(ssm_chunk=64, **kw):
            y, h = ssm_core(*args, h0=T(h0))
        assert (_bits_differ(y.numpy(), jy),
                _bits_differ(h.numpy(), jh)) == (0, 0)
        y1, h1 = ssm_core(*args, h0=T(h0))
        assert _bits_differ(y1.numpy(), y.numpy()) > 0  # another order
        if kw:
            assert _bits_differ(h1.numpy(), h.numpy()) > 0


@pytest.mark.parametrize("L", [1, 7])
def test_causal_conv1d_int_over_a_cached_window(L):
    rng = np.random.default_rng(L)
    win = rng.integers(-128, 128, (2, 3 + L, 64)).astype(np.int8)
    w = rng.integers(-128, 128, (4, 64)).astype(np.int8)
    b = rng.integers(-1000, 1000, (64,)).astype(np.int32)
    ref = j_causal_conv1d_int(win, w, b, 4)[:, -L:]
    got = causal_conv1d_int(*map(torch.from_numpy, (win, w, b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the reduced model -------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The port's seeded params (`init_np`, shared by both sides), both
    packages' calibrations of them on the entry point's sample, the
    reference's lm and its deploy, and the port's lm and the tables
    carried across."""
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


def test_calibrate_equals_reference(ref):
    """The port's float forward observes the reference's names, each
    range within TOL of the reference's span."""
    jc, tc = ref["jc"], ref["tc"]
    assert list(tc.hi) == list(jc.hi)
    assert sum(".mamba." in n for n in jc.hi) == 6 * 2
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n


def test_deploy_equals_reference_leaf_for_leaf(ref):
    """From the reference's ranges every table equals the reference's
    (float leaves within rtol 1e-5); from the port's own ranges only
    requant multipliers on a calibration boundary may move (counted)."""
    want = _np(ref["jt"])
    layer = want["segments"][0]
    assert set(layer) == {"norm", "core", "add"}
    assert set(layer["core"]) == {
        "in_proj", "xz_rqt", "conv_wq", "conv_bq", "conv_rqt", "conv_lut",
        "zp_conv", "x_proj", "xdb_rqt", "dt_proj", "dt_scale", "A", "Dv",
        "eps_conv_f", "zp_conv_f", "eps_xdb_f", "eps_y_inv", "z_lut", "zp_z",
        "gated_rqt", "out_proj"}
    assert _deploy_diff(want, ref["tlm"].deploy(_np(ref["p"]),
                                                ref["jc"])) == []
    off = _deploy_diff(want, ref["tlm"].deploy(_np(ref["p"]), ref["tc"]))
    print(f"requant multipliers on a calibration boundary: {off}")
    assert len(off) <= 4


def test_mamba_block_float_forward_equals_reference(ref):
    """Layer 0's float forward (norm, Mamba-1 core with its island,
    add) within TOL of max |ref|, and its float cache branch's new
    state."""
    jlm, tlm = ref["jlm"], ref["tlm"]
    p0 = jax.tree.map(lambda a: a[0], ref["p"]["segments"][0])
    x = np.random.default_rng(0).standard_normal((2, 9, 128)).astype(F32)
    jtpl = jlm.plan()[0][1]
    jy = jax.jit(lambda p, x: jtpl.apply_float(p, x, Rep.FP)[0])(p0, x)
    ty = tlm.block().apply_float(params_to_torch(_np(p0), "cpu"),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=TOL * float(np.abs(jy).max()))
    core = JQMamba1(128, d_state=16)
    rng = np.random.default_rng(1)
    cache = {"conv": rng.standard_normal((2, 3, 256)).astype(F32),
             "h": rng.standard_normal((2, 256, 16)).astype(F32)}
    jc = jax.jit(lambda p, x, c: core.apply_float(p, x, Rep.FP, cache=c)[1])(
        p0["core"], x, cache)
    _, tc = QMamba1(128).apply_float(
        params_to_torch(_np(p0["core"]), "cpu"), torch.from_numpy(x),
        cache={k: torch.from_numpy(v) for k, v in cache.items()})
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=TOL * float(np.abs(jc[k]).max()))


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
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.stride() == b.stride(), path
            assert torch.equal(a, b), path
        else:
            assert a == b, path

    eq(whole, streamed)
    core = streamed["layers"][0]["core"]
    # dt_proj's K (the rank, 8) padded to 16 in the stored (N, K) layout
    assert core["dt_proj"]["w_q"].shape == (16, 256)
    assert core["dt_proj"]["w_q"].stride() == (1, 16)
    assert not core["dt_proj"]["w_q"][8:].any()
    assert core["in_proj"]["w_q"].stride() == (1, 128)
    assert core["A"].dtype == core["dt_scale"].dtype == torch.float32


def _layer0(ref):
    jt0 = jax.tree.map(lambda a: a[0], ref["jt"]["segments"][0]["core"])
    return jt0, load_core(tree_to_torch(_np(jt0), "cpu"))


def _ref_apply_id(t, s_x, cache):
    """The reference's `QMamba1.apply_id`, its own functions in its
    order, with the stages it passes through returned: -> (s_z, s_conv,
    s_xdb, acc_dt, s_y, out, new conv window, h_last)."""
    from repro.core.intmath import apply_lut
    from repro.core.requant import apply_rqt
    from repro.layers.linear import QLinear as JQLinear

    di, ds, r = 256, 16, 8
    acc = JQLinear(128, 2 * di).apply_id(t["in_proj"], s_x)
    s_x1, s_z = jnp.split(apply_rqt(acc, t["xz_rqt"]), 2, axis=-1)
    conv_in = (jnp.concatenate([cache["conv"], s_x1], axis=1)
               if cache is not None else jnp.pad(
                   s_x1, ((0, 0), (3, 0), (0, 0))))
    c_acc = j_causal_conv1d_int(conv_in, t["conv_wq"], t["conv_bq"],
                                4)[:, -s_x1.shape[1]:]
    s_conv = apply_lut(apply_rqt(c_acc, t["conv_rqt"]), t["conv_lut"])
    s_xdb = apply_rqt(JQLinear(di, r + 2 * ds).apply_id(t["x_proj"], s_conv),
                      t["xdb_rqt"])
    s_dtr, s_B, s_C = jnp.split(s_xdb, [r, r + ds], axis=-1)
    acc_dt = JQLinear(r, di, use_bias=True).apply_id(t["dt_proj"], s_dtr)
    dt = jax.nn.softplus(acc_dt.astype(jnp.float32) * t["dt_scale"])
    x1f = (s_conv.astype(jnp.float32) - t["zp_conv_f"]) * t["eps_conv_f"]
    y, h_last = JQMamba1(128)._core_fp(
        x1f, dt, s_B.astype(jnp.float32) * t["eps_xdb_f"],
        s_C.astype(jnp.float32) * t["eps_xdb_f"], t["A"], t["Dv"],
        h0=None if cache is None else cache["h"], return_h=True)
    s_y = jnp.clip(jnp.round(y * t["eps_y_inv"]), -128, 127).astype(jnp.int8)
    return (s_z, s_conv, s_xdb, acc_dt, s_y, _ref_tail(t, s_z, s_y),
            conv_in[:, -3:], h_last)


def _ref_tail(t, s_z, s_y):
    """The reference's island exit: z LUT, the gate product, gated_rqt,
    out_proj."""
    from repro.core.intmath import apply_lut
    from repro.core.requant import apply_rqt
    from repro.layers.linear import QLinear as JQLinear

    s_zs = apply_lut(s_z, t["z_lut"])
    prod = s_y.astype(jnp.int32) * (s_zs.astype(jnp.int32) - t["zp_z"])
    return JQLinear(256, 128).apply_id(t["out_proj"],
                                       apply_rqt(prod, t["gated_rqt"]))


def _port_stages(t, s_x, cache):
    """The port's QMamba1.apply_id stages: -> (s_conv, s_xdb, acc_dt,
    s_y)."""
    from repro_torch.kernels import requant, requant_act
    from repro_torch.layers.ssm import _dt_proj

    m = QMamba1(128)
    s_xz = m._sub()["in_proj"].apply_id(t["in_proj"], s_x, t["xz_rqt"])
    s_x1 = s_xz[..., :256]
    conv_in = (torch.cat([cache["conv"], s_x1], 1) if cache is not None
               else torch.nn.functional.pad(s_x1, (0, 0, 3, 0)))
    s_conv = requant_act(requant(causal_conv1d_int(
        conv_in, t["conv_wq"], t["conv_bq"]), t["conv_rqt"]),
        {"lut": t["conv_lut"]})
    s_xdb = m._sub()["x_proj"].apply_id(t["x_proj"], s_conv, t["xdb_rqt"])
    acc_dt = _dt_proj(t["dt_proj"],
                      torch.nn.functional.pad(s_xdb[..., :8], (0, 8)), 256)
    s_y = m.island(t, acc_dt, s_conv, s_xdb[..., 8:24], s_xdb[..., 24:],
                   None if cache is None else cache["h"])[0]
    return s_conv, s_xdb, acc_dt, s_y


@pytest.mark.parametrize("L,cached", [(127, False), (128, False),
                                      (128, True), (200, True), (256, True)])
def test_qmamba1_apply_id_equals_reference(ref, L, cached):
    """Layer 0's `QMamba1.apply_id` at the chunk boundaries, without a
    cache and over a seeded cached window and state, against the
    reference's: its `apply_id` jitted, and its functions replayed in
    its order with their stages returned (`_ref_apply_id`).  Integer
    stages at tolerance 0: the island's inputs (s_conv, s_xdb, the dt
    accumulator), and the exit (z LUT, gate product, gated_rqt,
    out_proj) on the port's s_y; the new conv window and h bit for bit;
    the s_y images equal the replay's, out equals the replay's, and the
    positions of out that differ from the jitted `apply_id`'s are
    counted (0: XLA fuses the layer jitted alone as the port computes
    it, bit equality is not built in)."""
    jt0, tt0 = _layer0(ref)
    rng = np.random.default_rng(L + cached)
    B = 2 if cached else 1
    s_x = rng.integers(-128, 128, (B, L, 128)).astype(np.int8)
    cache = ({"conv": rng.integers(-128, 128, (B, 3, 256)).astype(np.int8),
              "h": (rng.standard_normal((B, 256, 16)) * 0.1).astype(F32)}
             if cached else None)
    j_z, *j_st, jout, jconv, jh = jax.jit(_ref_apply_id)(jt0, s_x, cache)
    jm = JQMamba1(128, d_state=16)
    rout, rnew = jax.jit(lambda t, s, c: jm.apply_id(t, s, cache=c))(
        jt0, s_x, cache)
    tcache = ({k: torch.from_numpy(v) for k, v in cache.items()}
              if cached else None)
    tx = torch.from_numpy(s_x)
    tout, tnew = QMamba1(128).apply_id(tt0, tx, tcache)
    t_st = _port_stages(tt0, tx, tcache)
    for name, a, b in zip(("s_conv", "s_xdb", "acc_dt"), t_st, j_st):
        assert a.dtype == {"acc_dt": torch.int32}.get(name, torch.int8)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    n_img = int((t_st[3].numpy() != np.asarray(j_st[3])).sum())
    # out_proj mixes a position's channels, so a differing s_y image
    # shows as one position of out that differs from the reference's
    n_pos = int((tout.numpy() != np.asarray(rout)).any(-1).sum())
    print(f"L {L} cached {cached}: s_y images differing {n_img} of "
          f"{t_st[3].numel()}; positions of out differing from the "
          f"reference's apply_id {n_pos} of {B * L}")
    assert (n_img, n_pos) == (0, 0)
    assert tout.dtype == torch.int32
    np.testing.assert_array_equal(
        tout.numpy(), np.asarray(_ref_tail(jt0, j_z, t_st[3].numpy())))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    if cached:
        for new in ({"conv": jconv, "h": jh}, rnew):
            np.testing.assert_array_equal(tnew["conv"].numpy(),
                                          np.asarray(new["conv"]))
            assert _bits_differ(tnew["h"].numpy(), new["h"]) == 0


@pytest.mark.parametrize("L", [9, 128])
def test_prefill_then_decode_equals_reference(ref, L):
    """The whole model (reference: its jitted `prefill` and
    `decode_step` over `init_caches`): a prefill of L tokens, then three
    decode steps: int32 logits, the conv state and h bit for bit."""
    jlm, jt, tlm, tt = ref["jlm"], ref["jt"], ref["tlm"], ref["tt"]
    rng = np.random.default_rng(L)
    toks = rng.integers(0, 256, (2, L)).astype(np.int32)
    jc = jlm.init_caches(2, MAX_LEN, Rep.ID)
    jl, jc = jax.jit(lambda t, b, c: jlm.prefill(t, b, c))(jt, toks, jc)
    tc = tlm.init_caches(2, MAX_LEN, device="cpu")
    tl = tlm.prefill(tt, torch.from_numpy(toks), tc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    dec = jax.jit(jlm.decode_step)
    for i in range(3):
        nxt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        pos = np.full((2,), L + i, np.int32)
        jl, jc = dec(jt, nxt, jc, pos)
        tl = tlm.decode_step(tt, torch.from_numpy(np.asarray(nxt)), tc,
                             torch.from_numpy(pos))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc["conv"].numpy(),
                                  np.asarray(jc[0]["conv"]))
    n_h = _bits_differ(tc["h"].numpy(), jc[0]["h"])
    print(f"prefill {L} + 3 decodes: h entries not bit-equal {n_h} of "
          f"{tc['h'].numel()}")
    assert n_h == 0


# -- the engine ---------------------------------------------------------------
# (prompt length, new tokens): a 1-token prompt among few distinct
# lengths, since the reference compiles a prefill per length (the
# chunk boundaries are held above, layer by layer and model-wide)
WORK = [(9, 6), (33, 4), (9, 5), (1, 6), (33, 3), (9, 4)]
# the preemption cell: two prompt lengths, the victim's re-prefill a third
WORK_PREEMPT = [(9, 6), (9, 5), (1, 6), (9, 4)]


def _engines(ref, *, paged, depth=0, policy=None):
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_depth=depth)
    if paged:
        kw.update(paged=True, page_size=8)
    j = JServingEngine(ref["jlm"], ref["jt"], JServingConfig(
        policy=policy() if policy else None,
        paged_kernel=False if paged else None,
        scheduler=JSchedulerConfig(), **kw))
    t = ServingEngine(ref["tlm"], ref["tt"], ServingConfig(
        device="cpu", policy=policy() if policy else None,
        scheduler=SchedulerConfig(), **kw))
    return j, t


def _state(a):
    s = {"owner": list(a.owner), "lengths": a.lengths.tolist(),
         "n_free": a.n_free}
    if hasattr(a, "page_table"):
        s.update(page_table=a.page_table.tolist(),
                 committed=a.committed_pages, free_pages=a.free_pages,
                 refcount=a.refcount.tolist())
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
    """Submit one request and step, then drain, both engines together.
    -> (reference, port) completions, or ("raised", message)."""
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


def _same_state(j, t):
    """The arena's conv and h state after the drain (slots and parked
    rows alike advance on both sides), h bit for bit."""
    jc = j.arena.caches[0]
    np.testing.assert_array_equal(t.arena.caches["conv"].numpy(),
                                  np.asarray(jc["conv"]))
    assert _bits_differ(t.arena.caches["h"].numpy(), jc["h"]) == 0


@pytest.mark.parametrize("paged,depth", [(False, 0), (True, 1)])
def test_tokens_equal_reference_in_exact_mode(ref, paged, depth):
    j, t = _engines(ref, paged=paged, depth=depth)
    assert t._prefill_mode == j._prefill_mode == "exact"
    assert isinstance(t.arena, SlotArena) != paged
    res = _lockstep(j, t)
    assert res[1] == res[0]
    assert sorted(len(toks) for _, toks, _, _ in res[1]) == sorted(
        g for _, g in WORK)
    assert t.stats()["steps"] == j.stats()["steps"]
    _same_state(j, t)


def test_scripted_preemption_as_the_reference(ref):
    """A decode evicted mid-generation over the paged arena at depth 0
    re-prefills prompt + tokens[:-1] from a zero state; the re-prefill's
    scan (one block) and the decodes' steps associate differently, so
    its last token may differ and the reference's resume oracle raise:
    the port raises the same at the same step, or, where the resume
    holds, both finish with equal tokens and preemption counts."""
    j, t = _engines(ref, paged=True,
                    policy=lambda: ScriptedPreemptions({3: "active"}))
    res = _lockstep(j, t, seed=1, work=WORK_PREEMPT)
    if isinstance(res, tuple):
        assert "resume parity violated" in res[1]
        print("ssm scripted preemption: the resume oracle raised on both")
        return
    assert res[1] == res[0]
    assert t.stats()["n_preempts"] == j.stats()["n_preempts"] > 0
    _same_state(j, t)


def test_serving_refusals_and_integer_caches_as_the_reference(ref):
    """kv_bits 4 and the prefix cache need the chunked path, which ssm
    never takes (the same message on both sides); the caches hold one
    float leaf, h, which only `allow_ssm_state` passes."""
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
    j, t = _engines(ref, paged=False)
    for check, caches in ((j_assert_integer_caches, j.arena.caches),
                          (assert_integer_caches, t.arena.caches)):
        check(caches, allow_ssm_state=True)
        with pytest.raises(AssertionError, match="'h'"):
            check(caches)
    assert t.arena.caches["h"].dtype == torch.float32
    assert t.arena.caches["conv"].dtype == torch.int8


def test_cli_serves_falcon_mamba(capsys):
    serve_main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--prompt-len", "12",
                "--gen", "3", "--max-len", "64", "--ragged"])
    out = capsys.readouterr().out
    assert "tok/s" in out or "throughput" in out


def test_config_family_and_depth_cut():
    """The config is the reference's; a cut depth keeps the width."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.ssm_kind, cfg.d_model, cfg.n_layers) == (
        "ssm", "mamba1", 4096, 64)
    lm = DecoderLM(dataclasses.replace(cfg, n_layers=2))
    assert lm.plan()[0][0] == "mamba" and lm.recurrent
    st = lm.init_state(3, device="cpu")
    assert st["conv"].shape == (2, 3, 3, 8192)
    assert st["h"].shape == (2, 3, 8192, 16)
