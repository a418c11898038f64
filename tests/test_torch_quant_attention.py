"""The port's quantized flash attention against the JAX reference.

On the CPU `quant_flash_attention` runs its plain version, which
follows the reference's Pallas kernel `_kernel` step for step: each
float32 step rounds once, and the ratios are `* float32(1/127)`.  It is
held at tolerance 0 against `_kernel_order`, an eager jnp transcription
of that kernel (JAX's exp, one op at a time), on the reference kernel
tests' four shapes, the GQA case of the reference's entry point
(`ops.quant_flash_attention`, kv heads repeated) and with S_q padded
to the query block and a causal q_offset.

Two reference functions round differently, by design or by compiler,
and are held within one quantum at no more than max(8, 1e-5 of) the
entries (`_close`), with the number of entries that move on each seed
pinned, so a change in rounding fails a test instead of fitting inside
the allowance:
  - the jnp mirror `ref.quant_flash_attention_ref` divides by 127;
  - the Pallas kernel itself, run in interpret mode as the reference's
    own tests run it, is compiled by XLA for the CPU, which contracts
    `acc * corr + pv * (1/127)` into one fused multiply-add.  Under
    this jax `pl.load` is gone, so the `pallas_kernel` fixture lends
    the kernel `ref[idx]` for the length of a test; nothing of the
    reference changes.
The CUDA kernel is built with --fmad=false and is held against the
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels import ref
from repro.kernels.quant_attention import quant_flash_attention_pallas
from repro_torch.kernels import quant_flash_attention
from repro_torch.kernels.quant_attention import (
    HEAD_DIMS, MMA_BKV, qfa_plan, quant_flash_attention_plain,
)


def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.fixture
def pallas_kernel(monkeypatch):
    """The reference's Pallas kernel in interpret mode on (BH, S, hd)
    arrays; `pl.load(ref, idx)` is `ref[idx]` where this jax lacks it."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda r, idx: r[idx],
                            raising=False)

    def run(q, k, v, **kw):
        return np.asarray(quant_flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    return run


def _kernel_order(q, k, v, *, score_scale, eps_ctx, causal=True,
                  q_offset=0, bq=128, bkv=128):
    """The Pallas `_kernel`'s arithmetic as eager jnp ops on (BH, S, hd)
    arrays: every float32 op rounds once, `* float32(1/127)`."""
    f32 = jnp.float32
    inv127, scale = f32(1.0 / 127.0), f32(score_scale)
    q32, k32 = jnp.asarray(q, jnp.int32), jnp.asarray(k, jnp.int32)
    v32 = jnp.asarray(v, jnp.int32)
    BH, S_q, hd = q.shape
    blocks = []
    for i in range(S_q // bq):
        qb = q32[:, i * bq:(i + 1) * bq]
        m = jnp.full((BH, bq), -1e9, f32)
        l_run = jnp.zeros((BH, bq), f32)
        acc = jnp.zeros((BH, bq, hd), f32)
        for j in range(k.shape[1] // bkv):
            s = jnp.einsum("bqd,bkd->bqk", qb, k32[:, j * bkv:(j + 1) * bkv])
            logits = s.astype(f32) * scale
            if causal:
                q_pos = q_offset + i * bq + jnp.arange(bq)[:, None]
                k_pos = j * bkv + jnp.arange(bkv)[None, :]
                logits = jnp.where(k_pos <= q_pos, logits, f32(-1e9))
            m_new = jnp.maximum(m, logits.max(-1))
            qp = jnp.round(jnp.exp(logits - m_new[..., None]) * f32(127.0))
            pv = jnp.einsum("bqk,bkd->bqd", qp.astype(jnp.int32),
                            v32[:, j * bkv:(j + 1) * bkv])
            corr = jnp.exp(m - m_new)
            acc = acc * corr[..., None] + pv.astype(f32) * inv127
            l_run = l_run * corr + qp.sum(-1) * inv127
            m = m_new
        ctx = acc / jnp.maximum(l_run, f32(1e-9))[..., None]
        blocks.append(jnp.clip(jnp.round(ctx * f32(1.0 / eps_ctx)),
                               -128, 127))
    return np.asarray(jnp.concatenate(blocks, axis=1).astype(jnp.int8))


def _mirror(q, k, v, **kw):
    return np.asarray(ref.quant_flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _close(got, want):
    """Within one quantum at no more than max(8, 1e-5 of) the entries."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    moved = int((diff != 0).sum())
    assert diff.max() <= 1 and moved <= max(8, int(1e-5 * diff.size)), \
        (moved, int(diff.max()))
    return moved


def _hold(got, moved, pallas_kernel, q, k, v, **kw):
    """got (BH, S, hd) against the three reference functions on the
    (BH, S_q padded to bq, hd) inputs, their first S rows; ``moved`` is
    the pinned pair of entries moved against the mirror and against
    the Pallas kernel."""
    S = got.shape[1]
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, _kernel_order(q, k, v, **kw)[:, :S])
    assert (_close(got, _mirror(q, k, v, **kw)[:, :S]),
            _close(got, pallas_kernel(q, k, v, **kw)[:, :S])) == moved


def _port(q, k, v, **kw):
    return quant_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("hd,S_q,S_kv,causal,moved", [
    (64, 128, 128, True, (0, 0)),
    (128, 128, 256, True, (0, 0)),
    (192, 128, 128, False, (0, 0)),
    (64, 256, 384, True, (1, 0)),
])
def test_matches_blockwise_ref(pallas_kernel, hd, S_q, S_kv, causal, moved):
    rng = np.random.default_rng(hd + S_q + S_kv)
    BH = 2
    q, k, v = _i8(rng, BH, S_q, hd), _i8(rng, BH, S_kv, hd), \
        _i8(rng, BH, S_kv, hd)
    kw = dict(score_scale=1e-4, eps_ctx=0.01, causal=causal, bq=128,
              bkv=128)
    # as B = 1 batch of BH heads, one kv head each
    got = _port(q[None], k[None], v[None], **kw)[0]
    _hold(got, moved, pallas_kernel, q, k, v, **kw)


def test_gqa_wrapper_matches_ref_with_repeated_kv(pallas_kernel):
    rng = np.random.default_rng(102)
    B, H, K, S, hd = 2, 8, 2, 128, 64
    q, k, v = _i8(rng, B, H, 128, hd), _i8(rng, B, K, S, hd), \
        _i8(rng, B, K, S, hd)
    got = _port(q, k, v, score_scale=1e-4, eps_ctx=0.01, n_rep=H // K)
    assert got.shape == (B, H, 128, hd) and got.dtype == np.int8
    kr = np.repeat(k, H // K, axis=1).reshape(B * H, S, hd)
    vr = np.repeat(v, H // K, axis=1).reshape(B * H, S, hd)
    _hold(got.reshape(B * H, 128, hd), (0, 0), pallas_kernel,
          q.reshape(B * H, 128, hd), kr, vr, score_scale=1e-4, eps_ctx=0.01)


@pytest.mark.parametrize("S_q,q_offset,moved", [
    (100, 0, (0, 0)), (40, 216, (0, 0)), (128, 128, (0, 1))])
def test_padded_queries_and_offset_match_ref(pallas_kernel, S_q, q_offset,
                                             moved):
    """S_q not a multiple of bq is padded with zero rows (dropped after);
    q_offset places row i at position q_offset + i, as in the reference
    entry point."""
    rng = np.random.default_rng(S_q + q_offset)
    B, H, K, S_kv, hd, bq, bkv = 1, 4, 2, 256, 64, 64, 64
    q, k, v = _i8(rng, B, H, S_q, hd), _i8(rng, B, K, S_kv, hd), \
        _i8(rng, B, K, S_kv, hd)
    kw = dict(score_scale=2e-4, eps_ctx=0.02, causal=True,
              q_offset=q_offset, bq=bq, bkv=bkv)
    got = _port(q, k, v, n_rep=H // K, **kw)
    pad = (-S_q) % bq
    qp = np.pad(q, ((0, 0), (0, 0), (0, pad), (0, 0)))
    kr = np.repeat(k, H // K, axis=1).reshape(B * H, S_kv, hd)
    vr = np.repeat(v, H // K, axis=1).reshape(B * H, S_kv, hd)
    _hold(got.reshape(B * H, S_q, hd), moved, pallas_kernel,
          qp.reshape(B * H, S_q + pad, hd), kr, vr, **kw)


def test_close_to_true_attention():
    """Blockwise probability quantization stays within a few ctx quanta
    of true float attention quantized on the same grid, and no worse on
    average than the model's unfused (global image) attention."""
    rng = np.random.default_rng(101)
    BH, S, hd = 2, 256, 64
    q, k, v = _i8(rng, BH, 128, hd), _i8(rng, BH, S, hd), _i8(rng, BH, S, hd)
    scale = 5e-5
    eps_ctx = 2.0 * 100.0 / 255.0
    kw = dict(score_scale=scale, eps_ctx=eps_ctx, causal=True)
    got = _port(q[None], k[None], v[None], **kw)[0].astype(np.int64)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.int64),
                  k.astype(np.int64)).astype(np.float64) * scale
    mask = np.arange(S)[None, None, :] > np.arange(128)[None, :, None]
    s = np.where(mask, -1e9, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    true_ctx = np.einsum("bqk,bkd->bqd", p, v.astype(np.float64))
    true_q = np.clip(np.round(true_ctx / eps_ctx), -128, 127)
    assert np.abs(got - true_q).max() <= 6, np.abs(got - true_q).max()
    want = np.asarray(ref.attention_unfused_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw), np.int64)
    assert np.abs(got - true_q).mean() <= np.abs(want - true_q).mean() + 0.1


def test_plain_batches_query_blocks_like_one_call_per_block():
    """The plain version batches every query block of every head into
    one tensor; it equals running each block on its own."""
    rng = np.random.default_rng(7)
    q, k, v = _i8(rng, 1, 2, 256, 32), _i8(rng, 1, 2, 256, 32), \
        _i8(rng, 1, 2, 256, 32)
    kw = dict(score_scale=3e-4, eps_ctx=0.02, causal=True, bq=64, bkv=64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    whole = quant_flash_attention_plain(*t, **kw)
    for i in range(4):
        part = quant_flash_attention_plain(
            t[0][:, :, 64 * i:64 * (i + 1)], *t[1:], q_offset=64 * i,
            **kw)
        assert torch.equal(part, whole[:, :, 64 * i:64 * (i + 1)])


def test_entry_point_validation():
    z = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    kv = torch.zeros((1, 1, 100, 64), dtype=torch.int8)
    kw = dict(score_scale=1e-4, eps_ctx=0.01)
    with pytest.raises(ValueError, match="multiple of bkv"):
        quant_flash_attention(z, kv, kv, n_rep=2, **kw)
    kv = torch.zeros((1, 1, 128, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="n_rep"):
        quant_flash_attention(z, kv, kv, n_rep=1, **kw)
    with pytest.raises(ValueError, match="q_offset"):
        quant_flash_attention(z, kv, kv, n_rep=2, q_offset=-1, **kw)
    with pytest.raises(ValueError, match="int8"):
        quant_flash_attention(z.int(), kv, kv, n_rep=2, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        quant_flash_attention(z.to("meta"), kv.to("meta"), kv.to("meta"),
                              n_rep=2, **kw)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("bkv", [32, 48, 64, 128, 256])
def test_plan_path_and_tile(hd, bkv):
    """`qfa_plan` picks the kernel from the shape alone: the tensor-core
    kernel for bkv 32, 64, 128, the CUDA-core kernel otherwise; GQA
    packs the largest of 4, 2, 1 query heads dividing n_rep into a
    block of 64 / heads rows; shared memory is the K/V ring plus V^T
    and fits a block; causal blocks are skipped unless score_scale
    could push key 0's logit to -1e9."""
    for n_rep in (1, 2, 3, 4, 8):
        for causal in (True, False):
            p = qfa_plan(n_rep, hd, 128, bkv, causal, 1 / 2048)
            assert p.skip == causal
            if bkv not in MMA_BKV:
                assert p.path == "simt" and (p.heads, p.rows) == (1, 128)
                assert p.smem == (128 * hd + 128 * bkv
                                  + max(4 * 128 * bkv, bkv * hd)
                                  + 4 * 128 * hd + 12 * 128)
                continue
            heads = {1: 1, 2: 2, 3: 1, 4: 4, 8: 4}[n_rep]
            assert p.path == "mma" and p.heads == heads
            assert p.rows == 64 // heads and p.rows % 16 == 0
            assert p.smem == 2 * 2 * bkv * (hd + 16) + hd * (bkv + 16)
            assert p.smem <= 227 * 1024
    assert not qfa_plan(1, hd, 64, bkv, True, 1e5).skip


def _key_order() -> np.ndarray:
    """sigma of csrc/quant_attention.cu: A column p of a 32-key P.V step
    holds key sigma[p], 4t + i -> 2t + i (i < 2) or 8 + 2t + i - 2, and
    16 more for the upper half."""
    return np.array([16 * h + 8 * (i // 2) + 2 * t + i % 2
                     for h in range(2) for t in range(4) for i in range(4)])


def test_permuted_pv_equals_unpermuted():
    """The image leaves the score C fragment in the order sigma: lane
    t of a quad holds keys 8n + 2t + {0, 1} of each 8-key tile n, and
    the m16n8k32 A fragment takes columns 4t..4t+3 (tiles 0, 1) and
    16 + 4t.. (tiles 2, 3) from the same lane.  sigma is a permutation
    of each 32-key chunk, and P.V over permuted P columns and V rows is
    the integer P.V exactly."""
    sigma = _key_order()
    assert sorted(sigma.tolist()) == list(range(32))
    for t in range(4):
        held = [8 * n + 2 * t + e for n in range(4) for e in range(2)]
        assert sorted(sigma[4 * t:4 * t + 4].tolist()
                      + sigma[16 + 4 * t:20 + 4 * t].tolist()) == held
    rng = np.random.default_rng(17)
    p = torch.from_numpy(rng.integers(0, 128, size=(16, 128)))
    v = torch.from_numpy(rng.integers(-128, 128, size=(128, 64)))
    perm = torch.from_numpy(np.concatenate(
        [32 * c + sigma for c in range(4)]))
    assert torch.equal(p[:, perm] @ v[perm], p @ v)
    assert not torch.equal(p @ v[perm], p @ v)


def test_magic_conversions_are_exact():
    """The tensor-core kernel converts int32 to float as the bits of
    1.5 * 2^23 plus s, less 1.5 * 2^23, for |s| < 2^22, and rounds 127 p
    to its byte as the low bits of 127 p + 1.5 * 2^23: equal to
    float32(s) and to rint (half to even) at every such input."""
    magic = np.float32(12582912.0)
    s = np.arange(-(1 << 22) + 1, 1 << 22, dtype=np.int32)
    f = (s + np.int32(0x4B400000)).view(np.float32) - magic
    assert np.array_equal(f, s.astype(np.float32))
    y = np.concatenate([np.arange(0, 128, 0.5, dtype=np.float32),
                        np.random.default_rng(0).uniform(
                            0, 127, 1 << 20).astype(np.float32)])
    low = ((y + magic).view(np.int32) & 0xFF)
    assert np.array_equal(low, np.rint(y).astype(np.int32))


def test_rows_are_independent_of_the_query_block():
    """The tensor-core kernel tiles queries by 16 rows, not by bq, and
    takes S_q unpadded: the plain version gives every row the same
    output whatever bq pads S_q to."""
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(_i8(rng, 1, 4, s, 64))
               for s in (100, 256, 256))
    kw = dict(score_scale=3e-4, eps_ctx=0.02, causal=True, q_offset=37,
              n_rep=2, bkv=64)
    k, v = k[:, :2], v[:, :2]
    want = quant_flash_attention_plain(q, k, v, bq=128, **kw)
    for bq in (4, 16, 50):
        assert torch.equal(quant_flash_attention_plain(q, k, v, bq=bq, **kw),
                           want)
