"""The port's int4-packed KV path (kv_bits 4) against the JAX reference.

Tolerance 0 throughout, inputs from numpy seeds: the nibble pack and
unpack over every cell, the per-head pack image and the (6, K) kernel
operand, the packed column write, the plain packed paged attention
against `ref.paged_attention_ref(k_rq=..., v_rq=...)`, one
`prefill_chunk` over packed pools (int32 logits and pools byte for
byte) and the engine's tokens against the reference's
`ServingEngine(paged=True, paged_kernel=False, kv_bits=4)`.  The
reference's packed Pallas kernel does not run under this jax, so its
jnp mirror and its write-then-gather path stand for it.  The card
kernel's way to the same unpack is transcribed in numpy and held
against `kv4_unpack`: its 16-entry table per kv head, the byte-permute
lookup through it, and the packed score fragments built from it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.intmath import pack_int4 as j_pack, unpack_int4 as j_unpack
from repro.core.requant import make_rqt
from repro.kernels import ref
from repro.launch import variants
from repro.launch.serve import deploy_model as j_deploy_model
from repro.layers.attention import (
    _kv4_operand as j_kv4_operand, _kv4_pack_image as j_kv4_pack_image,
    _paged_write as j_paged_write,
)
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.core.intmath import pack_int4, unpack_int4
from repro_torch.kernels import paged_attention, paged_attention_plain
from repro_torch.kernels.paged_attention import (
    check_kernel, kv4_unpack, staged_unpack_rq,
)
from repro_torch.launch.serve import main as serve_main
from repro_torch.layers.attention import (
    INACTIVE_POS, _kv4_operand, _kv4_pack_image, _paged_write, kv4_load,
)
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    PagedArena, SchedulerConfig, ServingConfig, ServingEngine,
)
from test_torch_gpu import floor_unpack

MAX_LEN = 40
PS = 8


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _loaded(kv4):
    """numpy kv4 trees -> torch, as `kv4_load` leaves them."""
    return kv4_load({n: _tt(t) for n, t in kv4.items()})


def _kv4_tables(rng, K):
    """Pack/unpack trees for K kv heads with distinct per-head quanta."""
    out = {}
    for short in ("k", "v"):
        eps4 = np.maximum(rng.uniform(0.5, 25.0, size=K), 1.0)
        out[f"{short}_pack"] = make_rqt(1.0 / eps4, 1.0, qmin=-8, qmax=7,
                                        acc_bound=127.0)
        out[f"{short}_unpack"] = make_rqt(eps4, 1.0, acc_bound=8.0)
    return out


# ---------------------------------------------------------------------
# nibbles, pack image, operand
# ---------------------------------------------------------------------
def test_pack_unpack_every_cell_matches_reference():
    """All 256 (lo, hi) pairs in [-8, 7]^2 pack to the reference's
    cells, and every one of the 256 int8 cells unpacks to the
    reference's pair."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    x = np.stack([lo.ravel(), hi.ravel()], axis=-1).astype(np.int8)
    got = pack_int4(torch.from_numpy(x))
    assert got.dtype == torch.int8 and got.shape == (256, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_pack(jnp.asarray(x))))
    np.testing.assert_array_equal(unpack_int4(got).numpy(), x)
    cells = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        unpack_int4(torch.from_numpy(cells)).numpy(),
        np.asarray(j_unpack(jnp.asarray(cells))))


def test_pack_rejects_odd_axis():
    with pytest.raises(ValueError, match="even"):
        pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv4_operand_and_pack_image_match_reference(seed):
    rng = np.random.default_rng(seed)
    K = 4
    kv4 = _kv4_tables(rng, K)
    for name, tree in kv4.items():
        want = np.asarray(j_kv4_operand(tree, K))
        got = _kv4_operand(_tt(tree), K)
        assert got.dtype == torch.int32 and got.shape == (6, K), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    x = rng.integers(-128, 128, size=(3, K, 7, 16)).astype(np.int8)
    loaded = _loaded(kv4)
    for short in ("k", "v"):
        tree = kv4[f"{short}_pack"]
        want = np.asarray(j_kv4_pack_image(jnp.asarray(x), tree))
        got = _kv4_pack_image(torch.from_numpy(x), loaded[f"{short}_pack"])
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    # a scalar tree (one head) repeats across K
    one = make_rqt(3.0, 1.0, acc_bound=8.0)
    np.testing.assert_array_equal(_kv4_operand(_tt(one), 4).numpy(),
                                  np.asarray(j_kv4_operand(one, 4)))


@pytest.mark.parametrize("seed", [3, 4])
def test_packed_column_write_matches_reference(seed):
    """Ragged chunks, PAGE_NULL table entries and parked rows: the
    packed pools after the port's in-place write equal the
    reference's `_paged_write(kv4=...)` pools byte for byte."""
    rng = np.random.default_rng(seed)
    n_pages, K, ps, hd = 6, 2, 4, 16
    B, S = 4, int(rng.integers(1, 6))
    kv4 = _kv4_tables(rng, K)
    shape = (n_pages + 1, K, ps, hd // 2)
    kp = rng.integers(-128, 128, size=shape).astype(np.int8)
    vp = rng.integers(-128, 128, size=shape).astype(np.int8)
    table = rng.integers(0, n_pages + 1, size=(B, 3)).astype(np.int32)
    pos = rng.integers(0, 3 * ps, size=(B,)).astype(np.int32)
    pos[1] = INACTIVE_POS
    k = rng.integers(-128, 128, size=(B, K, S, hd)).astype(np.int8)
    v = rng.integers(-128, 128, size=(B, K, S, hd)).astype(np.int8)
    _, want = j_paged_write(
        {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
         "table": jnp.asarray(table)},
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        kv4=jax.tree.map(jnp.asarray, kv4))
    cache = {"k": torch.from_numpy(kp.copy()),
             "v": torch.from_numpy(vp.copy()),
             "table": torch.from_numpy(table)}
    _paged_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(pos),
                 kv4=_loaded(kv4))
    for kv in ("k", "v"):
        np.testing.assert_array_equal(cache[kv].numpy(),
                                      np.asarray(want[kv]))


# ---------------------------------------------------------------------
# the plain packed paged attention against the reference's mirror
# ---------------------------------------------------------------------
def _packed_case(rng, *, B, K, group, S, ps, pps, n_pages, hd=32):
    H = K * group
    q = rng.integers(-127, 128, size=(B, H, S, hd)).astype(np.int8)
    kp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd // 2)).astype(
        np.int8)
    vp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd // 2)).astype(
        np.int8)
    table = rng.integers(0, n_pages + 1, size=(B, pps)).astype(np.int32)
    pos = rng.integers(0, pps * ps - S + 1, size=(B,)).astype(np.int32)
    pos[-1] = INACTIVE_POS
    kv4 = _kv4_tables(rng, K)
    k_rq = np.array(j_kv4_operand(kv4["k_unpack"], K))
    v_rq = np.array(j_kv4_operand(kv4["v_unpack"], K))
    return q, kp, vp, table, pos, k_rq, v_rq


@pytest.mark.parametrize("S,group", [(1, 1), (1, 4), (5, 1), (5, 4)])
def test_packed_paged_attention_plain_matches_ref(S, group):
    rng = np.random.default_rng(10 * S + group)
    q, kp, vp, table, pos, k_rq, v_rq = _packed_case(
        rng, B=3, K=2, group=group, S=S, ps=4, pps=4, n_pages=9)
    scale = np.float32(0.02)
    want = np.asarray(ref.paged_attention_ref(
        *map(jnp.asarray, (q, kp, vp, table, pos)), score_scale=scale,
        group=group, k_rq=jnp.asarray(k_rq), v_rq=jnp.asarray(v_rq)))
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    got = paged_attention(*args, torch.tensor(scale), group=group,
                          k_rq=torch.from_numpy(k_rq),
                          v_rq=torch.from_numpy(v_rq))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv4_unpack_matches_reference_page_unpack():
    rng = np.random.default_rng(8)
    K = 3
    kv4 = _kv4_tables(rng, K)
    rq = np.array(j_kv4_operand(kv4["v_unpack"], K))
    pool = rng.integers(-128, 128, size=(4, K, 5, 8)).astype(np.int8)
    got = kv4_unpack(torch.from_numpy(pool), torch.from_numpy(rq)).numpy()
    for page in range(4):
        for kh in range(K):
            want = ref.kv4_unpack_page_ref(jnp.asarray(pool[page, kh]),
                                           jnp.asarray(rq), kh)
            np.testing.assert_array_equal(got[page, kh], np.asarray(want))


# ---------------------------------------------------------------------
# the card kernel's per-block unpack tables and nibble lookups, in numpy
# ---------------------------------------------------------------------
def _sra(x, s):
    """int32 arithmetic shift right as the kernel's `sra`: shifts of 31
    and over (and negative ones) give the sign."""
    s = np.asarray(s, np.int64)
    return np.where((s < 0) | (s >= 31), x >> 31,
                    x >> np.clip(s, 0, 31)).astype(np.int32)


def kernel_unpack_table(rq):
    """The tables a block of the packed kernel builds: `Unpack::one((n ^
    8) - 8)` for the 16 nibble values n of each kv head, (K, 16) int8,
    transcribed in int32 with the multiply and the add wrapping."""
    m, s0, lo, hi, d, zp = (np.asarray(r, np.int32)[:, None] for r in rq)
    x = (np.arange(16, dtype=np.int32) ^ 8) - 8
    x = np.minimum(np.maximum(x, lo), hi)
    staged = (_sra(x, s0).astype(np.uint32) * m.astype(np.uint32)).astype(
        np.int32)
    y = (_sra(staged, d - s0).astype(np.uint32) + zp.astype(np.uint32)
         ).astype(np.int32)
    return np.clip(y, -128, 127).astype(np.int8)


def _nibbles(pool):
    """The raw nibbles (0..15) of a packed pool, element 2i from the low
    nibble of byte i."""
    u = pool.view(np.uint8)
    return np.stack([u & 15, u >> 4], axis=-1).reshape(
        *pool.shape[:-1], 2 * pool.shape[-1])


def _unpack_cols(case, K, rng):
    if case == "staged":
        return staged_unpack_rq(K).numpy()
    if case == "reference":
        return np.array(j_kv4_operand(_kv4_tables(rng, K)["v_unpack"], K))
    if case == "random":
        s0 = rng.integers(0, 34, K)
        lo = rng.integers(-10, 4, K)
        return np.stack([rng.integers(-2**31, 2**31, K), s0, lo,
                         lo + rng.integers(0, 12, K),
                         s0 + rng.integers(-2, 34, K),
                         rng.integers(-2**20, 2**20, K)]).astype(np.int32)
    # x * m wraps int32 for |x| >= 4: 4 (2^29 + 3) = 2^31 + 12
    col = [2**29 + 3, 0, -8, 7, 24, 0]
    return np.array([col] * K, np.int32).T.copy()


@pytest.mark.parametrize("case", ["staged", "reference", "random",
                                  "wrapping"])
def test_kernel_unpack_table_equals_kv4_unpack(case):
    """The 16-entry table per kv head, indexed by every nibble of a
    seeded packed pool, is `kv4_unpack` of that pool (the reference's
    page unpack for operands from its own `_kv4_operand`): for the
    operands the card checks use, the reference's, seeded random
    columns (shifts of 31 and over, and below 0) and a column whose
    multiply wraps int32."""
    rng = np.random.default_rng(31)
    K = 8
    rq = _unpack_cols(case, K, rng)
    pool = rng.integers(-128, 128, size=(5, K, 4, 16)).astype(np.int8)
    tab = kernel_unpack_table(rq)
    got = tab[np.arange(K)[None, :, None, None], _nibbles(pool)]
    want = kv4_unpack(torch.from_numpy(pool), torch.from_numpy(rq)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "reference":
        for kh in range(K):
            np.testing.assert_array_equal(got[1, kh], np.asarray(
                ref.kv4_unpack_page_ref(jnp.asarray(pool[1, kh]),
                                        jnp.asarray(rq), kh)))
    if case == "wrapping":  # without the wrap the images would differ
        x = np.arange(-8, 8, dtype=np.int64)
        unwrapped = np.clip((x * (2**29 + 3)) >> 24, -128, 127)
        assert not np.array_equal(tab[0, (x & 15)], unwrapped)


def test_packed_u16_nibble_j_is_element_4i_plus_j():
    """The selector identity the kernel's lookups rest on: the
    little-endian u16 at packed byte 2i holds elements 4i..4i+3, element
    4i+j in bits 4j..4j+3."""
    pool = np.random.default_rng(32).integers(
        -128, 128, size=(3, 2, 4, 16)).astype(np.int8)
    u16 = pool.view("<u2")
    nib = (u16[..., None] >> (4 * np.arange(4))) & 15
    elems = unpack_int4(torch.from_numpy(pool)).numpy()
    np.testing.assert_array_equal(
        nib.reshape(*pool.shape[:-1], -1), elems.view(np.uint8) & 15)


def _prmt(a, b, c):
    """PTX prmt.b32 in its default mode, over uint32 arrays: byte j of
    the result is byte c[4j+2:4j] of {b, a}, or where c[4j+3] is set that
    byte's sign bit replicated; c[31:16] is not read."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(
        a, np.uint64)
    c = np.asarray(c, np.uint64)
    out = np.zeros(np.broadcast(src, c).shape, np.uint64)
    for j in range(4):
        sel = (c >> np.uint64(4 * j)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (sel & np.uint64(7)))) & np.uint64(255)
        sign = np.where(byte & np.uint64(128), np.uint64(255), np.uint64(0))
        out |= np.where(sel & np.uint64(8), sign, byte) << np.uint64(8 * j)
    return out.astype(np.uint32)


def _unpack4(c, tb):
    """The kernel's `unpack4`: four nibbles (c[15:0]) through a 16-byte
    table held as four uint32 (entry n in byte n % 4 of tb[n // 4])."""
    c = np.asarray(c, np.uint32)
    lo = _prmt(tb[0], tb[1], c)
    hi = _prmt(tb[2], tb[3], c ^ np.uint32(0x8888))
    m = _prmt(c << np.uint32(4), c, 0xD9C8)
    return (lo & ~m) | (hi & m)


@pytest.mark.parametrize("case", ["staged", "random"])
def test_unpack4_equals_the_table_lookup(case):
    """`unpack4` (two permutes and a select on each nibble's top bit)
    gives, for every one of the 65536 u16 selectors, with or without
    bits above 16, the word of the four nibbles' table entries."""
    rng = np.random.default_rng(33)
    tabs = (kernel_unpack_table(staged_unpack_rq(8).numpy())
            if case == "staged"
            else rng.integers(-128, 128, size=(8, 16)).astype(np.int8))
    c = np.arange(1 << 16, dtype=np.uint32)
    high = rng.integers(0, 1 << 16, size=c.shape).astype(np.uint32) << 16
    for tab in tabs:
        tb = tab.view("<u4")
        want = np.zeros_like(c)
        for j in range(4):
            want |= tab.view(np.uint8)[(c >> (4 * j)) & 15].astype(
                np.uint32) << (8 * j)
        np.testing.assert_array_equal(_unpack4(c, tb), want)
        np.testing.assert_array_equal(_unpack4(c | high, tb), want)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_packed_score_fragments_give_the_scores(hd):
    """The packed kernel's score fragments, built lane by lane as the
    kernel builds them (Q's A registers from hd 32c + 8t and + 4; K's
    two B registers from the 4 packed bytes at 16c + 4t of key g's row,
    expanded by `unpack4`) and put through the m16n8k32 product's
    definition, give q . k over the unpacked keys exactly."""
    rng = np.random.default_rng(34 + hd)
    q = rng.integers(-128, 128, size=(16, hd)).astype(np.int8)
    rows = rng.integers(-128, 128, size=(8, hd // 2)).astype(np.int8)
    tab = kernel_unpack_table(staged_unpack_rq(3).numpy())[2]
    tb = tab.view("<u4")
    kimg = tab[_nibbles(rows)]
    d = np.zeros((16, 8), np.int64)
    for c in range(hd // 32):
        a = np.zeros((16, 32), np.int64)
        bm = np.zeros((32, 8), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            col = 32 * c + 8 * t
            for r in (g, g + 8):
                a[r, 4 * t:4 * t + 4] = q[r, col:col + 4]
                a[r, 16 + 4 * t:20 + 4 * t] = q[r, col + 4:col + 8]
            w = rows[g].view("<u4")[(16 * c + 4 * t) // 4]
            for lo_k, half in ((4 * t, w & 0xFFFF), (16 + 4 * t, w >> 16)):
                word = _unpack4(np.uint32(half), tb)
                bm[lo_k:lo_k + 4, g] = np.array(
                    [word], np.uint32).view(np.int8)
        d += a @ bm
    np.testing.assert_array_equal(
        d, q.astype(np.int64) @ kimg.astype(np.int64).T)


def _wrong_unpack(pool, rq, kind):
    if kind == "swapped_heads":
        return kv4_unpack(pool, torch.flip(rq, dims=[1]))
    return floor_unpack(pool, rq)


@pytest.mark.parametrize("kind,which", [
    ("floor_shift", "kv"), ("floor_shift", "v"), ("swapped_heads", "kv"),
    ("swapped_heads", "k")])
def test_packed_check_rejects_a_wrong_unpack(kind, which):
    """`check_kernel`, the card's tolerance for the packed mode, rejects
    the output of a kernel whose unpack is wrong in K (the image moves)
    or in V (P.V differs), and passes the right one."""
    rng = np.random.default_rng(12)
    K, group, S = 3, 2, 4
    q, kp, vp, table, pos, _, _ = _packed_case(
        rng, B=3, K=K, group=group, S=S, ps=4, pps=4, n_pages=9)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    scale = torch.tensor(np.float32(1.0 / 64.0))
    k_rq = staged_unpack_rq(K)
    v_rq = torch.roll(k_rq, 1, dims=1)
    k8 = (_wrong_unpack(args[1], k_rq, kind) if "k" in which
          else kv4_unpack(args[1], k_rq))
    v8 = (_wrong_unpack(args[2], v_rq, kind) if "v" in which
          else kv4_unpack(args[2], v_rq))
    bad, bad_qp = paged_attention_plain(args[0], k8, v8, *args[3:], scale,
                                        group=group, return_qp=True)
    with pytest.raises(AssertionError):
        check_kernel(bad, bad_qp, *args, scale, group=group, k_rq=k_rq,
                     v_rq=v_rq)
    good, good_qp = paged_attention_plain(*args, scale, group=group,
                                          k_rq=k_rq, v_rq=v_rq,
                                          return_qp=True)
    assert check_kernel(good, good_qp, *args, scale, group=group,
                        k_rq=k_rq, v_rq=v_rq) == (0, 0)


def test_packed_mode_operand_errors():
    q = torch.zeros((1, 1, 1, 32), dtype=torch.int8)
    packed = torch.zeros((2, 1, 4, 16), dtype=torch.int8)
    full = torch.zeros((2, 1, 4, 32), dtype=torch.int8)
    table = torch.zeros((1, 1), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    scale = torch.tensor(0.02)
    rq = torch.zeros((6, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_rq/v_rq"):
        paged_attention(q, packed, packed, table, pos, scale)
    with pytest.raises(ValueError, match="not packed"):
        paged_attention(q, full, full, table, pos, scale, k_rq=rq, v_rq=rq)
    with pytest.raises(ValueError, match="k_rq/v_rq must be"):
        paged_attention(q, packed, packed, table, pos, scale,
                        k_rq=rq.reshape(3, 2), v_rq=rq)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q.to(**meta), packed.to(**meta), packed.to(**meta),
                        table.to(**meta), pos.to(**meta), scale.to(**meta),
                        k_rq=rq.to(**meta), v_rq=rq.to(**meta))


# ---------------------------------------------------------------------
# model and engine on reduced granite
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jlm, jt = j_deploy_model("granite_3_2b", reduced=True, max_seq=MAX_LEN)
    tlm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=MAX_LEN)
    tt = tables_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    return jlm, jt, tlm, tt


def test_tables_carry_int32_kv4(models):
    *_, tt = models
    kv4 = tt["layers"][1]["attn"]["kv4"]
    assert set(kv4) == {"k_pack", "k_unpack", "v_pack", "v_unpack",
                        "k_rq", "v_rq"}
    for name in ("k_pack", "k_unpack", "v_pack", "v_unpack"):
        assert all(t.dtype == torch.int32 for t in kv4[name].values())
        assert kv4[name]["m"].shape == (2,)  # one column per kv head
    for name in ("k_rq", "v_rq"):
        assert kv4[name].dtype == torch.int32
        assert kv4[name].shape == (6, 2)


def test_loaded_kv4_matches_reference_operands(models):
    """What `load_layer` builds once per layer equals what the
    reference builds on every call: the (6, K) unpack operands, and a
    pack rounding term that gives the reference's pack image."""
    _, jt, tlm, tt = models
    K = tlm.cfg.n_kv_heads
    rng = np.random.default_rng(9)
    x = rng.integers(-128, 128, size=(2, K, 3, tlm.cfg.hd)).astype(np.int8)
    for i, layer in enumerate(tt["layers"]):
        j_kv4 = jax.tree.map(lambda a: a[i], jt["segments"][0]["attn"]["kv4"])
        for short in ("k", "v"):
            np.testing.assert_array_equal(
                layer["attn"]["kv4"][f"{short}_rq"].numpy(),
                np.asarray(j_kv4_operand(j_kv4[f"{short}_unpack"], K)))
            np.testing.assert_array_equal(
                _kv4_pack_image(torch.from_numpy(x),
                                layer["attn"]["kv4"][f"{short}_pack"]).numpy(),
                np.asarray(j_kv4_pack_image(jnp.asarray(x),
                                            j_kv4[f"{short}_pack"])))


@pytest.mark.parametrize("C", [1, 6])
def test_prefill_chunk_over_packed_pools_matches(models, C):
    """One unified dispatch over stale packed pools (chunks inside,
    across and on page boundaries, a parked row, PAGE_NULL holes):
    int32 logits and both packed pools equal byte for byte."""
    jlm, jt, tlm, tt = models
    cfg = tlm.cfg
    B, pps, n_pages = 5, MAX_LEN // PS, 25
    rng = np.random.default_rng(30 + C)
    shape = (cfg.n_layers, n_pages + 1, cfg.n_kv_heads, PS, cfg.hd // 2)
    k = rng.integers(-128, 128, size=shape).astype(np.int8)
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    table = rng.permutation(np.arange(1, n_pages + 1))[:B * pps].reshape(
        B, pps).astype(np.int32)
    table[2, 2:] = 0
    table[4] = 0
    pos = np.array([3, 5, 8, 31 - C, INACTIVE_POS], np.int32)
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
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kv in ("k", "v"):
        assert t_caches[kv].shape[-1] == cfg.hd // 2
        np.testing.assert_array_equal(t_caches[kv].numpy(),
                                      np.asarray(j_new[0][kv]))


def test_engine_kv4_tokens_match_reference(models):
    """The workload of the reference's kv4 engine tests: 4 prompts of
    4-13 tokens, 6 new tokens each, 2 slots, page 8, chunk 4."""
    jlm, jt, tlm, tt = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tlm.cfg.vocab, size=(int(n),))
               for n in rng.integers(4, 14, size=4)]
    gens = [6] * len(prompts)

    def drain(eng):
        for p, g in zip(prompts, gens):
            eng.submit(p, max_new_tokens=g)
        return {c.req_id: list(map(int, c.tokens))
                for c in eng.run_until_drained()}

    want = drain(JServingEngine(jlm, jt, JServingConfig(
        n_slots=2, max_len=MAX_LEN, paged=True, page_size=PS,
        paged_kernel=False, kv_bits=4,
        scheduler=JSchedulerConfig(prefill_bucket=PS, prefill_chunk=4))))
    eng = ServingEngine(tlm, tt, ServingConfig(
        n_slots=2, max_len=MAX_LEN, paged=True, page_size=PS, kv_bits=4,
        device="cpu",
        scheduler=SchedulerConfig(prefill_chunk=4)))
    got = drain(eng)
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert eng.stats()["kv_bits"] == 4


def test_arena_packed_geometry_and_validation(models):
    *_, tlm, _ = models
    a8 = PagedArena(tlm, 2, MAX_LEN, PS, 6, device="cpu")
    a4 = PagedArena(tlm, 2, MAX_LEN, PS, 6, device="cpu", kv_bits=4)
    for kv in ("k", "v"):
        s8, s4 = a8.caches[kv].shape, a4.caches[kv].shape
        assert s4 == s8[:-1] + (s8[-1] // 2,)
        assert a4.caches[kv].dtype == torch.int8
    s8, s4 = a8.stats(), a4.stats()
    assert (s8["kv_bits"], s4["kv_bits"]) == (8, 4)
    # K and V, 6 pages + the trash page, one int8 per element at 8 bits
    assert s8["pool_bytes"] == 2 * s4["pool_bytes"] == (
        2 * tlm.cfg.n_layers * 7 * tlm.cfg.n_kv_heads * PS * tlm.cfg.hd)
    with pytest.raises(ValueError, match="kv_bits"):
        PagedArena(tlm, 2, MAX_LEN, PS, 6, device="cpu", kv_bits=3)
    with pytest.raises(ValueError, match="kv_bits"):
        ServingConfig(kv_bits=5)
    assert ServingConfig(paged=True, kv_bits=4).kv_bits == 4


def test_cli_kv4_smoke(capsys):
    serve_main(["--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--prompt-len", "12", "--gen", "3",
                "--max-len", "16", "--ragged", "--paged", "--kv-bits",
                "4"])
    out = capsys.readouterr().out
    assert "drained 3 requests / 9 tokens" in out
    assert "kv_bits 4" in out
