"""The blockwise attention above 4096 query rows (the reference's
`QAttention._blockwise_id`) in the port, against the JAX reference at
tolerance 0, on reduced granite_3_2b at max_seq 8192.

The reference takes its streaming path in the dense branch of
`apply_id` whenever a dispatch has more than 4096 query rows: over a
contiguous cache (every whole-prompt B=1 prefill, `serve_batch`, a
chunked dispatch over `SlotArena`) and on the write-then-gather path
over pools, under either softmax.  Held here: the s_ctx images of the
function itself; `lm.prefill` (logits and K/V bytes) and
`serve_batch`; the engine's bucketed mode over both arenas, the port
at `paged_kernel` True and False against the reference's gather path;
a chunked `SlotArena` dispatch of 4104 rows; the integer softmax; the
key-count check; and `exp_image`, the image the island computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.layers.attention as j_attention
from repro.core.rep import Rep
from repro.launch import variants as j_variants
from repro.launch.serve import (
    deploy_model as j_deploy_model, serve_batch as j_serve_batch,
)
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.core.island import exp_f32, exp_image
from repro_torch.launch import variants
from repro_torch.launch.serve import serve_batch
from repro_torch.layers.attention import (
    BLOCKWISE_BLOCK, BLOCKWISE_THRESHOLD, _blockwise_attend,
)
from repro_torch.kernels.requant_kernel import requant
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    PagedArena, SchedulerConfig, ServingConfig, ServingEngine, SlotArena,
)

MAX_SEQ = 8192


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside the suite's other workers, intra-op threads only contend
    for the cores, so this module runs torch on one thread (restored
    after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_SEQ)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_SEQ)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def _prompt(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(n,)).astype(
        np.int32)


def test_exp_image_equals_the_lowered_exp_image():
    """exp_image against round(127 exp_f32(x)) on a dense grid of
    [-8, 0], on the half-integer edges of the image and at its ends."""
    x = torch.linspace(-8.0, 0.0, 1 << 20, dtype=torch.float32)
    k = torch.arange(0, 127, dtype=torch.float64) + 0.5
    edges = torch.log(k / 127.0).to(torch.float32)
    near = torch.cat([torch.nextafter(edges, torch.tensor(-1.0)), edges,
                      torch.nextafter(edges, torch.tensor(1.0))])
    ends = torch.tensor([0.0, -0.0, -1e9, -87.9, -88.0, -1e-30],
                        dtype=torch.float32)
    for v in (x, near, ends):
        want = torch.round(exp_f32(v) * 127.0).to(torch.int8)
        assert torch.equal(exp_image(v), want)


def _j_blockwise(jattn, t, q, kh, vh, pos):
    return np.asarray(jax.jit(
        lambda t, q, k, v: jattn._blockwise_id(t, q, k, v, pos))(
            t, q, kh, vh))


@pytest.mark.parametrize("S,T,scale", [(4097, 6144, 1e-4),
                                       (2300, 4096, 2e-3)])
def test_blockwise_s_ctx_images_equal_reference(models, S, T, scale,
                                                monkeypatch):
    """The function alone at granite's reduced geometry (4 heads, 2 kv
    heads, hd 32) on random int8 q, K, V, a small and a larger logit
    scale, through layer 0's ctx_rqt: 0 s_ctx images differ.  Every
    product it hands the grouped GEMM is laid out as the kernel takes
    it (x contiguous, w stored (E, N, K))."""
    import repro_torch.layers.attention as t_attention

    grouped = t_attention.int8_matmul_grouped

    def checked(x, w, *a, **kw):
        E, K_, N = w.shape
        assert x.is_contiguous() and w.stride() == (N * K_, 1, K_)
        return grouped(x, w, *a, **kw)

    monkeypatch.setattr(t_attention, "int8_matmul_grouped", checked)
    jlm, jt, tlm, tt = models
    at = tt["layers"][0]["attn"]
    c = tlm.cfg
    H, K, hd = c.n_heads, c.n_kv_heads, c.hd
    rng = np.random.default_rng(S)
    q = rng.integers(-128, 128, (1, H, S, hd)).astype(np.int8)
    k = rng.integers(-128, 128, (1, K, T, hd)).astype(np.int8)
    v = rng.integers(-128, 128, (1, K, T, hd)).astype(np.int8)
    jattn = j_attention.QAttention(c.d_model, H, K, hd, max_seq=MAX_SEQ)
    jtab = {"score_scale": np.float32(scale),
            "ctx_rqt": jax.tree.map(np.asarray, jt["segments"][0]["attn"][
                "ctx_rqt"])}
    jtab["ctx_rqt"] = jax.tree.map(lambda a: a[0], jtab["ctx_rqt"])
    g = H // K
    want = _j_blockwise(jattn, jtab, q, np.repeat(k, g, 1),
                        np.repeat(v, g, 1), 0)
    acc = _blockwise_attend(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            torch.zeros(1, dtype=torch.int32),
                            torch.tensor(np.float32(scale)), g)
    got = requant(acc, at["ctx_rqt"], heads_to_rows=True)
    got = got.view(1, S, H, hd).permute(0, 2, 1, 3).numpy()
    assert int((got != want).sum()) == 0


def _kv_equal(jcaches, tcaches, B, T):
    ref = jcaches[0]
    for kv in ("k", "v"):
        want = np.asarray(ref[kv])                         # (L, B, K, T, hd)
        got = tcaches[kv][:, 1:B + 1].numpy()
        np.testing.assert_array_equal(got, want, err_msg=kv)


@pytest.mark.parametrize("S,T", [(4097, 6144), (6000, 8192)])
def test_prefill_equals_reference(models, S, T):
    """lm.prefill over a contiguous cache of T positions: logits and
    every layer's K/V bytes."""
    jlm, jt, tlm, tt = models
    prompt = _prompt(S, seed=S)[None]
    jl, jc = jax.jit(jlm.prefill)(jt, jnp.asarray(prompt),
                                  jlm.init_caches(1, T, Rep.ID))
    tc = tlm.init_caches(1, T, device="cpu")
    tl = tlm.prefill(tt, torch.from_numpy(prompt), tc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _kv_equal(jc, tc, 1, T)


def test_integer_softmax_still_streams_above_4096(models):
    """Under attn_softmax "int" the reference's width check comes first,
    so 4097 rows take the float blockwise path on both sides."""
    jlm, jt, tlm, tt = models
    S, T = 4097, 6144
    prompt = _prompt(S, seed=7)[None]
    with j_variants.use_variants(attn_softmax="int"):
        jl, jc = jax.jit(jlm.prefill)(jt, jnp.asarray(prompt),
                                      jlm.init_caches(1, T, Rep.ID))
    tc = tlm.init_caches(1, T, device="cpu")
    with variants.use_variants(attn_softmax="int"):
        tl = tlm.prefill(tt, torch.from_numpy(prompt), tc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _kv_equal(jc, tc, 1, T)


def test_serve_batch_equals_reference(models):
    """A row of 6140 tokens and 4 new ones over 6144 positions."""
    jlm, jt, tlm, tt = models
    prompts = _prompt(6140, seed=1)[None]
    want = np.asarray(j_serve_batch(jlm, jt, jnp.asarray(prompts), 4))
    got = serve_batch(tlm, tt, prompts, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_key_count_check_matches_the_reference_assert(models):
    """A contiguous cache whose length is no multiple of 2048: the
    reference asserts, the port raises; one of 6144 runs on both."""
    jlm, jt, tlm, tt = models
    prompt = _prompt(BLOCKWISE_THRESHOLD + 1, seed=3)[None]
    T = 5000
    assert T % BLOCKWISE_BLOCK and BLOCKWISE_BLOCK == 2048
    with pytest.raises(AssertionError):
        jax.jit(jlm.prefill)(jt, jnp.asarray(prompt),
                             jlm.init_caches(1, T, Rep.ID))
    with pytest.raises(ValueError, match="T % 2048 == 0"):
        tlm.prefill(tt, torch.from_numpy(prompt),
                    tlm.init_caches(1, T, device="cpu"))


def _drain(eng, prompts, gen):
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    done = {c.req_id: (list(map(int, c.tokens)), c.finish_reason)
            for c in eng.run_until_drained()}
    return [done[i] for i in ids]


PROMPTS = [(4097, 11), (9, 12)]
GEN = 4
ENGINE_LEN = 6144


@pytest.mark.parametrize("paged", [False, True])
def test_bucketed_engine_equals_reference(models, paged):
    """prefill_chunk 0 (bucket 16) over SlotArena and PagedArena at
    max_len 6144: each long prompt's B=1 prefill streams over the
    scratch cache on both sides; the port at paged_kernel True and
    False against the reference's gather path."""
    jlm, jt, tlm, tt = models
    prompts = [_prompt(n, seed=s) for n, s in PROMPTS]
    kw = dict(n_slots=2, max_len=ENGINE_LEN)
    if paged:
        kw.update(paged=True, page_size=256)
    j = JServingEngine(jlm, jt, JServingConfig(
        scheduler=JSchedulerConfig(prefill_chunk=0, prefill_bucket=16),
        **dict(kw, **({"paged_kernel": False} if paged else {}))))
    want = _drain(j, prompts, GEN)
    for kernel in (True, False):
        t = ServingEngine(tlm, tt, ServingConfig(
            device="cpu", paged_kernel=kernel,
            scheduler=SchedulerConfig(prefill_chunk=0, prefill_bucket=16),
            **kw))
        assert isinstance(t.arena, PagedArena if paged else SlotArena)
        assert _drain(t, prompts, GEN) == want, kernel
        assert t.stats()["steps"] == j.stats()["steps"]


def test_chunked_slot_arena_dispatch_of_4104_rows(models):
    """A chunked dispatch over SlotArena at prefill_chunk 4104: the
    check that refused it is gone, and the dispatch streams on both
    sides (a 4097-token prompt in one chunk beside a decode row)."""
    jlm, jt, tlm, tt = models
    prompts = [_prompt(n, seed=s) for n, s in PROMPTS]
    kw = dict(n_slots=2, max_len=ENGINE_LEN)
    j = JServingEngine(jlm, jt, JServingConfig(
        scheduler=JSchedulerConfig(prefill_chunk=4104), **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        device="cpu", scheduler=SchedulerConfig(prefill_chunk=4104), **kw))
    assert t._prefill_mode == "chunked"
    assert _drain(t, prompts, GEN) == _drain(j, prompts, GEN)
    for kv in ("k", "v"):
        np.testing.assert_array_equal(
            t.arena.caches[kv][:, 1:].numpy(),
            np.asarray(j.arena.caches[0][kv]), err_msg=kv)
