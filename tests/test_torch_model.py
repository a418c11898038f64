"""The port's integer layers and model against the JAX reference on
reduced granite_3_2b (2 layers, d 128, 4 heads / 2 kv heads, vocab 256),
tolerance 0 throughout.

Both packages get the same tables (one module-scoped reference deploy,
converted by `tables_from_numpy`) and the same numpy inputs.  Paged
attention on the reference side runs its write-then-gather path
(`variants paged_decode="gather"`), which runs under this jax; the
port runs its kernel wrapper (the plain version on the CPU).  After
each paged call the KV pools must be equal byte for byte — the trash
page included — and the reference's returned pools are compared
against the port's in-place-updated ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import variants
from repro.launch.serve import deploy_model as j_deploy_model
from repro.layers.add import QAdd as JQAdd
from repro.layers.mlp import QMLP as JQMLP
from repro.layers.norms import QNorm as JQNorm
from repro_torch.configs.base import get_config
from repro_torch.layers.add import QAdd
from repro_torch.layers.attention import INACTIVE_POS
from repro_torch.layers.mlp import QMLP
from repro_torch.layers.norms import QNorm
from repro_torch.models.lm import DecoderLM, tables_from_numpy

MAX_SEQ = 64
PS, PPS, N_PAGES = 8, 8, 24  # T = 64 logical positions per slot


@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_SEQ)
    t_np = jax.tree.map(np.asarray, jt)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_SEQ)
    return jlm, jt, tlm, tables_from_numpy(t_np, device="cpu")


def _layer(jt, i):
    return jax.tree.map(lambda x: x[i], jt["segments"][0])


def _arena(rng, cfg, B):
    """Random (stale) pools + a table with distinct pages per row, a
    row that owns no pages, and PAGE_NULL holes."""
    shape = (cfg.n_layers, N_PAGES + 1, cfg.n_kv_heads, PS, cfg.hd)
    k = rng.integers(-128, 128, size=shape).astype(np.int8)
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    pages = rng.permutation(np.arange(1, N_PAGES + 1))
    table = np.zeros((B, PPS), np.int32)
    table[0, :3] = pages[:3]
    table[1, :5] = pages[3:8]
    table[2, :2] = pages[8:10]
    table[3, :PPS] = pages[10:10 + PPS]
    return k, v, table


def _starts(B, S):
    # chunk inside a page / across pages / on a boundary / parked / late
    base = np.array([3, 5, 8, INACTIVE_POS, 56 - S], np.int32)
    return base[:B]


def test_qnorm_matches(models):
    _, jt, _, tt = models
    rng = np.random.default_rng(0)
    s = rng.integers(-128, 128, size=(5, 7, 128)).astype(np.int8)
    s[0, 0] = 0  # all-zero row: the isqrt / reciprocal edge
    for i, name in ((0, "norm1"), (1, "norm2")):
        want = JQNorm(128).apply_id(_layer(jt, i)[name], jnp.asarray(s))
        got = QNorm(128).apply_id(tt["layers"][i][name], torch.from_numpy(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = JQNorm(128).apply_id(jt["norm_f"], jnp.asarray(s))
    got = QNorm(128).apply_id(tt["norm_f"], torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qmlp_and_qadd_match(models):
    _, jt, _, tt = models
    rng = np.random.default_rng(1)
    s = rng.integers(-128, 128, size=(4, 6, 128)).astype(np.int8)
    for i in range(2):
        want = JQMLP(128, 256).apply_id(_layer(jt, i)["mlp"], jnp.asarray(s))
        got = QMLP(128, 256).apply_id(tt["layers"][i]["mlp"],
                                      torch.from_numpy(s))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        acc = np.array(want)
        want_add = JQAdd().apply_id(_layer(jt, i)["add2"], jnp.asarray(s),
                                    jnp.asarray(acc))
        got_add = QAdd().apply_id(tt["layers"][i]["add2"],
                                  torch.from_numpy(s), torch.from_numpy(acc))
        assert got_add.dtype == torch.int8
        np.testing.assert_array_equal(got_add.numpy(), np.asarray(want_add))


@pytest.mark.parametrize("S", [1, 6])
def test_paged_attention_layer_and_block_match(models, S):
    jlm, jt, tlm, tt = models
    cfg = tlm.cfg
    B = 5
    rng = np.random.default_rng(10 + S)
    k, v, table = _arena(rng, cfg, B)  # row 4 owns no pages
    pos = _starts(B, S)
    s_x = rng.integers(-128, 128, size=(B, S, cfg.d_model)).astype(np.int8)
    j_blk = jlm._dense_tpl(False)
    j_attn = j_blk._subs()["attn"]
    t_blk = tlm.block()
    t_attn = t_blk._subs()["attn"]
    for fn_j, fn_t, name in (
        (lambda t, x, c: j_attn.apply_id(t["attn"], x, cache=c,
                                         pos=jnp.asarray(pos)),
         lambda t, x, c: t_attn.apply_id(t["attn"], x, c,
                                         torch.from_numpy(pos)), "attn"),
        (lambda t, x, c: j_blk.apply_id(t, x, cache=c, pos=jnp.asarray(pos)),
         lambda t, x, c: t_blk.apply_id(t, x, c, torch.from_numpy(pos)),
         "block"),
    ):
        j_cache = {"k": jnp.asarray(k[0]), "v": jnp.asarray(v[0]),
                   "table": jnp.asarray(table)}
        t_cache = {"k": torch.from_numpy(k[0].copy()),
                   "v": torch.from_numpy(v[0].copy()),
                   "table": torch.from_numpy(table)}
        with variants.use_variants(paged_decode="gather"):
            want, j_new = fn_j(_layer(jt, 0), jnp.asarray(s_x), j_cache)
        got = fn_t(tt["layers"][0], torch.from_numpy(s_x), t_cache)
        assert got.dtype == (torch.int32 if name == "attn" else torch.int8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        for kv in ("k", "v"):
            np.testing.assert_array_equal(
                t_cache[kv].numpy(), np.asarray(j_new[kv]),
                err_msg=f"{name} pool {kv}")


@pytest.mark.parametrize("C", [1, 8])
def test_prefill_chunk_logits_and_pools_match(models, C):
    """The unified dispatch: decode rows (width 1 inside a C-wide
    dispatch), chunk rows across and on page boundaries, a parked
    row; int32 logits at every row's last index and both pools after
    the call, byte for byte."""
    jlm, jt, tlm, tt = models
    cfg = tlm.cfg
    B = 5
    rng = np.random.default_rng(20 + C)
    k, v, table = _arena(rng, cfg, B - 1)
    table = np.concatenate([table, np.zeros((1, PPS), np.int32)])
    pos = _starts(B, C)
    toks = rng.integers(0, cfg.vocab, size=(B, C)).astype(np.int32)
    last = rng.integers(0, C, size=B).astype(np.int32)
    j_caches = [{"k": jnp.asarray(k), "v": jnp.asarray(v),
                 "table": jnp.broadcast_to(jnp.asarray(table),
                                           (cfg.n_layers,) + table.shape)}]
    with variants.use_variants(paged_decode="gather"):
        want, j_new = jax.jit(jlm.prefill_chunk)(
            jt, jnp.asarray(toks), j_caches, jnp.asarray(pos),
            jnp.asarray(last))
    t_caches = {"k": torch.from_numpy(k.copy()),
                "v": torch.from_numpy(v.copy()),
                "table": torch.from_numpy(table)}
    got = tlm.prefill_chunk(tt, torch.from_numpy(toks), t_caches,
                            torch.from_numpy(pos), torch.from_numpy(last))
    assert got.dtype == torch.int32
    assert got.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kv in ("k", "v"):
        np.testing.assert_array_equal(t_caches[kv].numpy(),
                                      np.asarray(j_new[0][kv]))
    # greedy tokens agree too (first index on ties, like jnp.argmax)
    np.testing.assert_array_equal(
        torch.argmax(got[:, 0], dim=-1).numpy(),
        np.asarray(jnp.argmax(want[:, 0], axis=-1)))
