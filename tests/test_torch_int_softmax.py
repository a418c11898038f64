"""The port's integer-only attention (`attn_softmax="int"`) and the
write-then-gather path, against the JAX reference at tolerance 0.

Reduced granite_3_2b (2 layers, d 128, 4/2 heads, hd 32; max_len 48,
pages of 8), inputs from numpy seeds.  The reference runs under its
own `use_variants` (``attn_softmax="int"`` or ``paged_decode=
"gather"``), so its Pallas kernel is never reached.  Held here:

  - `make_int_softmax_tables` leaf for leaf at eps_s 1e-6 to 1e-2, and
    the deploy's `sm_tabs` (int32 after `tables_from_numpy`);
  - `int_softmax` byte for byte, with and without masks, on cells
    whose lanes overflow int32 (counted), a fully masked row and T 37;
    within 2 quanta of the float oracle where logits stay within 8;
  - `QAttention.apply_id` under the integer softmax at kv_bits 8 and
    4, S 1 and a chunk, with a parked row and PAGE_NULL holes at T 40
    (the P.V product pads T to 48): the int32 wo accumulator and both
    pools; under the float island the gather path equals the port's
    kernel path (its plain version) and the reference's gather path;
    the kv_bits 4 view unpack equals the reference's
    `apply_rqt(unpack_int4(view), unpack, channel_axis=1)`;
  - no op with a floating output in `apply_id` under the integer
    softmax (the plain GEMMs exempt: they multiply in exact float32 on
    the CPU only), and some under the float island;
  - engine tokens, finish reasons, steps and preemptions against the
    reference engine under `attn_softmax="int"` in five cells (slot
    arena chunked and bucketed, paged chunked and bucketed at kv_bits
    8, paged chunked at 4) and at dispatch depth 1; `paged_kernel=False`
    under the float island gives the default engine's tokens on both
    arenas;
  - `assert_integer_caches`, the variants' switches and the CLI's
    `--paged-gather`.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.intmath import unpack_int4 as j_unpack
from repro.core.intsoftmax import (
    int_softmax as j_int_softmax,
    make_int_softmax_tables as j_make_tables,
)
from repro.core.requant import apply_rqt as j_apply_rqt
from repro.configs.base import get_config as j_get_config
from repro.launch import variants as j_variants
from repro.layers.attention import QAttention as JQAttention
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.core.intsoftmax import (
    int_softmax, int_softmax_load, int_softmax_ref_float,
    make_int_softmax_tables,
)
from repro_torch.kernels.paged_attention import gathered_view, kv4_unpack
from repro_torch.launch import variants
from repro_torch.launch.serve import calibration_sample, main as serve_main
from repro_torch.layers.attention import INACTIVE_POS, QAttention
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    PagedArena, SchedulerConfig, ServingConfig, ServingEngine, SlotArena,
)
from repro_torch.serving.cache import (
    assert_integer_caches, float_cache_leaves,
)
from test_torch_cnn import _FloatOutputs

MAX_LEN, PS, N_SLOTS = 48, 8, 3
EPS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
# (prompt length, new tokens): one and two chunks of 4 (one bucket of 8,
# so each bucketed reference compiles one prefill), a 1-token prompt;
# four requests over three slots
SPECS = [(8, 5), (6, 4), (3, 6), (1, 4)]
CHUNK = 4


def _torch_tabs(tabs):
    return {k: torch.from_numpy(np.array(v)) for k, v in tabs.items()}


@jax.jit
def _j_softmax(s, tabs, mask):
    return j_int_softmax(s, tabs, mask=mask)


def _overflow_lanes(s, mask, m_ln2):
    """Lanes where the reference's int32 (-t_c) * m_ln2 wraps."""
    s = np.where(mask, s, -(2 ** 30)).astype(np.int64)
    t_c = np.maximum(s - s.max(-1, keepdims=True), -(2 ** 26))
    prod = -t_c * int(m_ln2)
    return int(((prod > 2 ** 31 - 1) | (prod < -(2 ** 31))).sum())


# ---------------------------------------------------------------------
# tables and the softmax
# ---------------------------------------------------------------------
@pytest.mark.parametrize("eps_s", EPS)
def test_tables_match_reference(eps_s):
    want, got = j_make_tables(eps_s), make_int_softmax_tables(eps_s)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# (eps_s, score amplitude, masked share, T): every cell but the first
# has int32-overflow lanes
SOFTMAX_CASES = [(1e-6, 2 ** 22, 0.0, 64), (1e-5, 10 ** 4, 0.3, 37),
                 (1e-4, 2 ** 22, 0.3, 37), (1e-3, 100, 0.5, 16),
                 (1e-2, 10 ** 4, 0.3, 130), (3e-3, 2 ** 22, 0.0, 37)]


@pytest.mark.parametrize("eps_s,amp,masked,T", SOFTMAX_CASES)
def test_int_softmax_matches_reference(eps_s, amp, masked, T):
    rng = np.random.default_rng(int(eps_s * 1e7) + T)
    tabs = j_make_tables(eps_s)
    s = rng.integers(-amp, amp, size=(2, 4, 5, T)).astype(np.int32)
    mask = rng.random((2, 1, 5, T)) >= masked
    mask[1, 0, 2, :] = False  # a fully masked row: uniform
    want = np.asarray(_j_softmax(jnp.asarray(s), tabs, jnp.asarray(mask)))
    got = int_softmax(torch.from_numpy(s), _torch_tabs(tabs),
                      mask=torch.from_numpy(mask))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.numpy()[1, :, 2].ravel().tolist())) == 1
    if masked or eps_s > 1e-6:
        assert _overflow_lanes(s, mask, tabs["m_ln2"]) > 0
    # without a mask too
    want = np.asarray(_j_softmax(jnp.asarray(s), tabs, None))
    np.testing.assert_array_equal(
        int_softmax(torch.from_numpy(s), _torch_tabs(tabs)).numpy(), want)


@pytest.mark.parametrize("eps_s", [1e-4, 4e-3])
def test_int_softmax_near_the_float_oracle(eps_s):
    rng = np.random.default_rng(7)
    lim = int(8.0 / eps_s)  # logits within +-8
    s = torch.from_numpy(rng.integers(-lim, lim, size=(6, 96)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((6, 96)) > 0.4)
    got = int_softmax(s, _torch_tabs(make_int_softmax_tables(eps_s)),
                      mask=mask).to(torch.int64)
    ref = int_softmax_ref_float(s, eps_s, mask=mask).to(torch.int64)
    assert int((got - ref).abs().max()) <= 2
    assert bool((got[~mask] == 0).all())


def test_int_softmax_load_checks_dtypes():
    tabs = _torch_tabs(make_int_softmax_tables(1e-3))
    loaded = int_softmax_load(tabs)
    assert all(v.dim() == 0 and v.dtype == torch.int32
               for k, v in loaded.items() if k != "exp_lut")
    assert loaded["exp_lut"].shape == (256,)
    with pytest.raises(ValueError, match="int32"):
        int_softmax_load({**tabs, "m_ln2": tabs["m_ln2"].to(torch.int64)})


# ---------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """One calibrated deploy (the port's, which equals the reference's
    leaf for leaf: tests/test_torch_calibrate.py) on both sides."""
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    p = tlm.init_np(0)
    t_np = tlm.deploy(p, tlm.calibrate(p, calibration_sample(
        tlm.cfg.vocab, MAX_LEN), device="cpu"))
    jlm = JLM(j_get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    return (jlm, jax.tree.map(jnp.asarray, t_np), tlm,
            tables_from_numpy(t_np, device="cpu"))


def test_deploy_emits_sm_tabs(models):
    """Each layer's `sm_tabs` are the reference's tables at its score
    quantum (the deploy leaf for leaf against the reference's: the
    deploy, calibrate, configs, dense-variant and MoE test files), and
    load as 0-d int32 scalars of their own and the (256,) int32 LUT."""
    _, jt, tlm, tt = models
    seg = jt["segments"][0]["attn"]
    for i, layer in enumerate(tt["layers"]):
        want = j_make_tables(float(np.asarray(seg["score_scale"])[i]))
        deployed = {k: np.asarray(v)[i] for k, v in seg["sm_tabs"].items()}
        got = layer["attn"]["sm_tabs"]
        assert set(got) == set(deployed) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(deployed[k], v, err_msg=k)
            assert got[k].dtype == torch.int32 and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
            if k != "exp_lut":
                assert got[k]._base is None  # not a view of the stack


def _attn_pair(tlm):
    c = tlm.cfg
    kw = dict(rope_base=c.rope_base, rope_fraction=c.rope_fraction,
              max_seq=MAX_LEN)
    return (JQAttention(c.d_model, c.n_heads, c.n_kv_heads, c.hd, **kw),
            QAttention(c.d_model, c.n_heads, c.n_kv_heads, c.hd, **kw))


def _layer_inputs(tlm, S, kv_bits, seed):
    """Stale random pools of 21 pages, a table of 5 pages a slot (T 40)
    with PAGE_NULL holes, a parked row."""
    c = tlm.cfg
    rng = np.random.default_rng(seed)
    B, pps, n_pages = 4, 5, 20
    hd = c.hd // 2 if kv_bits == 4 else c.hd
    shape = (n_pages + 1, c.n_kv_heads, PS, hd)
    k = rng.integers(-128, 128, size=shape).astype(np.int8)
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    table = rng.permutation(np.arange(1, n_pages + 1)).reshape(
        B, pps).astype(np.int32)
    table[2, 3:] = 0
    pos = np.array([0, 9, 17 - S // 2, INACTIVE_POS], np.int32)
    s_x = rng.integers(-128, 128, size=(B, S, c.d_model)).astype(np.int8)
    return s_x, k, v, table, pos


_J_APPLY = {}


def _j_apply(jattn, j_kw):
    """The reference's apply_id, jitted once per variant setting (the
    variants are read at trace time)."""
    key = tuple(sorted(j_kw.items()))
    if key not in _J_APPLY:
        def fn(t, s_x, cache, pos):
            with j_variants.use_variants(**j_kw):
                return jattn.apply_id(t, s_x, cache=cache, pos=pos)
        _J_APPLY[key] = jax.jit(fn)
    return _J_APPLY[key]


def _run_layer(models, i, S, kv_bits, seed, j_kw, t_kw):
    """The reference's and the port's apply_id of layer i on one input,
    each under its own variants -> ((ref acc, ref pools), (port acc,
    port pools))."""
    _, jt, tlm, tt = models
    jattn, tattn = _attn_pair(tlm)
    s_x, k, v, table, pos = _layer_inputs(tlm, S, kv_bits, seed)
    jtab = jax.tree.map(lambda a: jnp.asarray(a)[i], jt["segments"][0]["attn"])
    acc, jc = _j_apply(jattn, j_kw)(
        jtab, jnp.asarray(s_x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                 "table": jnp.asarray(table)},
        jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "table": torch.from_numpy(table)}
    with variants.use_variants(**t_kw):
        got = tattn.apply_id(tt["layers"][i]["attn"], torch.from_numpy(s_x),
                             cache, torch.from_numpy(pos))
    return ((np.asarray(acc), np.asarray(jc["k"]), np.asarray(jc["v"])),
            (got.numpy(), cache["k"].numpy(), cache["v"].numpy()))


LAYER_CASES = [(8, 1), (8, 6), (4, 1), (4, 6)]


@pytest.mark.parametrize("kv_bits,S", LAYER_CASES)
def test_apply_id_int_softmax_matches_reference(models, kv_bits, S):
    for i in range(2):
        want, got = _run_layer(models, i, S, kv_bits, 40 + S + kv_bits,
                               dict(attn_softmax="int"),
                               dict(attn_softmax="int"))
        for name, a, b in zip(("wo acc", "K pool", "V pool"), want, got):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("kv_bits,S", LAYER_CASES)
def test_gather_float_equals_kernel_and_reference(models, kv_bits, S):
    seed = 60 + S + kv_bits
    want, gather = _run_layer(models, 1, S, kv_bits, seed,
                              dict(paged_decode="gather"),
                              dict(paged_decode="gather"))
    _, kernel = _run_layer(models, 1, S, kv_bits, seed,
                           dict(paged_decode="gather"), {})
    for a, b, c in zip(want, gather, kernel):
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(b, a)


def test_int_path_differs_from_the_float_island(models):
    """The switch bites: one chunk's accumulator moves between islands."""
    ref = dict(paged_decode="gather")
    _, gather = _run_layer(models, 0, 6, 8, 5, ref, ref)
    _, integer = _run_layer(models, 0, 6, 8, 5, ref, dict(
        attn_softmax="int"))
    assert not np.array_equal(gather[0], integer[0])


def test_kv4_view_unpack_matches_reference(models):
    _, jt, tlm, tt = models
    _, k, _, table, _ = _layer_inputs(tlm, 1, 4, 3)
    view = gathered_view(torch.from_numpy(k), torch.from_numpy(table), 1)
    for i, layer in enumerate(tt["layers"]):
        j_kv4 = jax.tree.map(lambda a: jnp.asarray(a)[i],
                             jt["segments"][0]["attn"]["kv4"])
        for short in ("k", "v"):
            want = j_apply_rqt(j_unpack(jnp.asarray(view.numpy())),
                               j_kv4[f"{short}_unpack"], channel_axis=1)
            got = kv4_unpack(view, layer["attn"]["kv4"][f"{short}_rq"])
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("softmax", ["int", "float"])
def test_apply_id_integer_only(models, monkeypatch, softmax):
    _, _, tlm, tt = models
    _, tattn = _attn_pair(tlm)
    s_x, k, v, table, pos = _layer_inputs(tlm, 6, 8, 11)
    gemm = sys.modules["repro_torch.kernels.int8_matmul"]
    mode = _FloatOutputs()
    for name in ("int8_matmul_plain", "int8_matmul_grouped_plain"):
        plain = getattr(gemm, name)

        def exempt(*a, _plain=plain, **kw):
            mode.exempt += 1
            try:
                return _plain(*a, **kw)
            finally:
                mode.exempt -= 1

        monkeypatch.setattr(gemm, name, exempt)
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
             "table": torch.from_numpy(table)}
    with variants.use_variants(attn_softmax=softmax,
                               paged_decode="gather"), mode:
        tattn.apply_id(tt["layers"][0]["attn"], torch.from_numpy(s_x), cache,
                       torch.from_numpy(pos))
    assert mode.seen > 40
    if softmax == "int":
        assert not mode.ops, mode.ops
    else:
        assert mode.ops  # the float island shows


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------
def _workload(vocab):
    rng = np.random.default_rng(21)
    return [(rng.integers(0, vocab, size=(p,)), g) for p, g in SPECS]


def _drain(eng, workload):
    for p, g in workload:
        eng.submit(p, max_new_tokens=g)
    done = eng.run_until_drained()
    s = eng.stats()
    return ({c.req_id: (list(map(int, c.tokens)), c.finish_reason)
             for c in done}, s["steps"], s["n_preempts"])


def _engine(models, port, *, paged, chunk, kv_bits=8, depth=0,
            paged_kernel=None):
    jlm, jt, tlm, tt = models
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN, dispatch_depth=depth)
    if paged:
        kw.update(paged=True, page_size=PS, kv_bits=kv_bits)
    sched = dict(prefill_chunk=chunk, prefill_bucket=PS)
    if port:
        return ServingEngine(tlm, tt, ServingConfig(
            device="cpu", paged_kernel=paged_kernel,
            scheduler=SchedulerConfig(**sched), **kw))
    return JServingEngine(jlm, jt, JServingConfig(
        paged_kernel=False, scheduler=JSchedulerConfig(**sched), **kw))


# (paged, chunk, kv_bits, depth)
ENGINE_CELLS = [(False, CHUNK, 8, 0), (False, 0, 8, 0), (True, CHUNK, 8, 0),
                (True, 0, 8, 0), (True, CHUNK, 4, 0), (True, CHUNK, 8, 1)]


@pytest.mark.parametrize("paged,chunk,kv_bits,depth", ENGINE_CELLS)
def test_engine_int_softmax_matches_reference(models, paged, chunk, kv_bits,
                                              depth):
    work = _workload(models[2].cfg.vocab)
    cell = dict(paged=paged, chunk=chunk, kv_bits=kv_bits, depth=depth)
    with j_variants.use_variants(attn_softmax="int"):
        want = _drain(_engine(models, False, **cell), work)
    with variants.use_variants(attn_softmax="int"):
        got = _drain(_engine(models, True, **cell), work)
    assert got == want
    assert [len(got[0][r][0]) for r in range(len(work))] == [
        g for _, g in work]


@pytest.mark.parametrize("paged", [False, True])
def test_paged_kernel_false_gives_the_default_tokens(models, paged):
    work = _workload(models[2].cfg.vocab)
    want = _drain(_engine(models, True, paged=paged, chunk=CHUNK), work)
    eng = _engine(models, True, paged=paged, chunk=CHUNK, paged_kernel=False)
    assert not eng.paged_kernel
    assert _drain(eng, work) == want


def test_assert_integer_caches(models):
    tlm = models[2]
    arenas = [SlotArena(tlm, 2, MAX_LEN, device="cpu")] + [
        PagedArena(tlm, 2, MAX_LEN, PS, 8, device="cpu", kv_bits=b)
        for b in (8, 4)]
    for a in arenas:
        assert float_cache_leaves(a.caches) == []
        assert_integer_caches(a.caches)
    tree = {"k": torch.zeros(2, dtype=torch.int8),
            "layers": [{"h": torch.zeros(2)}, {"v": torch.zeros(2)}]}
    assert float_cache_leaves(tree) == [("['layers'][0]['h']", torch.float32),
                                        ("['layers'][1]['v']", torch.float32)]
    with pytest.raises(AssertionError, match="integer-only"):
        assert_integer_caches(tree)
    with pytest.raises(AssertionError, match=r"\['v'\]"):
        assert_integer_caches(tree, allow_ssm_state=True)


def test_variants_switches():
    assert variants.get("attn_softmax") == "float"
    assert variants.get("paged_decode") == "kernel"
    with variants.use_variants(attn_softmax="int"):
        with variants.use_variants(paged_decode="gather"):
            assert (variants.get("attn_softmax"),
                    variants.get("paged_decode")) == ("int", "gather")
        assert variants.get("paged_decode") == "kernel"
    assert variants.get("attn_softmax") == "float"
    with pytest.raises(KeyError):
        with variants.use_variants(kv_shard="batch"):
            pass
    with pytest.raises(KeyError):
        variants.get("moe_group")
    assert (variants.get("ssm_chunk"),
            variants.get("ssm_island_dtype")) == (0, "f32")
    assert variants.parse("attn_softmax=int,paged_decode=gather") == {
        "attn_softmax": "int", "paged_decode": "gather"}
    assert variants.parse("") == {}


def test_cli_paged_gather(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--gen", "3",
                "--max-len", "16", "--ragged", "--paged", "--paged-gather"])
    out = capsys.readouterr().out
    assert "drained 3 requests / 9 tokens" in out
