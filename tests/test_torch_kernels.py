"""The port's kernel wrappers against the JAX reference kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests
hold that version against the reference's jnp mirrors
(`kernels/ref.py`) and the Pallas kernels that run here in interpret
mode, at tolerance 0 on every int32/int8 output.  The paged-attention
cases cover S = 1 and S = C, chunks inside a page, across a page and
on a page boundary, recycled tables with stale pages, parked
(INACTIVE_POS) rows and GQA group 4.  The tolerance that the card's
check applies to the kernel's probability image (`check_image`) is
shown here to reject images a wrong kernel would make.  The
paged-attention kernel's own choices are held here too: its row sum's
ownership of the 32 partials (emulated in numpy, bit for bit against
`_lane_sum`), its exp (`island_exp`: within 1 ulp, 0 below -104, and
a scalar float32 evaluation of the kernel's steps gives its bits), its
causal horizon stop (exact under its guard, and a
planted case just outside the guard that it would get wrong), and
`paged_plan`'s launch at every shape the port runs, over int8 pools
and int4-packed ones.

The CUDA kernels themselves run only on the card; their tests are in
tests/test_torch_gpu.py.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.requant import apply_rqt as j_apply_rqt, make_rqt
from repro.kernels import ref
from repro.kernels.int8_matmul import int8_matmul_requant_pallas
from repro.kernels.requant_kernel import requant_pallas
from repro.layers.linear import QLinear as JQLinear
from repro_torch.kernels import (
    int8_matmul, int8_matmul_plain, paged_attention, requant,
)
from repro_torch.kernels.int8_matmul import (
    SMS, WGMMA_K_MAX, WGMMA_TILES, gemm_plan,
)
from repro_torch.kernels.paged_attention import (
    _SMEM_LIMIT, MMA_SHAPES, NEG_INF, STOP_GUARD, _lane_sum, _mma_smem,
    attention_probs, check_image, gathered_view, horizon_stop, island_exp,
    paged_plan,
)
from repro_torch.layers.attention import INACTIVE_POS

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _gemm_operands(rng, M, K, N):
    x = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    w = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    b = rng.integers(-(1 << 20), 1 << 20, size=N).astype(np.int32)
    return x, w, b


def _w_kernel_layout(w):
    """(K, N) values stored (N, K) contiguous, as tables_from_numpy does."""
    return torch.from_numpy(np.ascontiguousarray(w.T)).t()


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 256, 384)])
def test_int8_matmul_requant_matches_pallas_and_ref(M, K, N):
    rng = np.random.default_rng(M + N)
    x, w, b = _gemm_operands(rng, M, K, N)
    rq = make_rqt(rng.uniform(1e-5, 4e-5, size=N), 0.05,
                  acc_bound=float(K * 127 * 127))
    d, zp = int(rq["d"]), int(rq["zp"])
    kargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
             jnp.asarray(rq["m"]), jnp.asarray(rq["s0"]))
    want_ref = np.asarray(ref.int8_matmul_requant_ref(*kargs, d=d, zp=zp))
    want_pl = np.asarray(int8_matmul_requant_pallas(*kargs, d=d, zp=zp))
    # the reference kernels skip the pre-clip: open it to compare
    open_rq = dict(rq, lo=np.full(N, I32_MIN, np.int32),
                   hi=np.full(N, I32_MAX, np.int32))
    got = int8_matmul(torch.from_numpy(x), _w_kernel_layout(w),
                      torch.from_numpy(b), _tt(open_rq)).numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pl)


@pytest.mark.parametrize("M,K,N", [(8, 128, 256), (1, 2, 3), (37, 130, 66)])
def test_int8_matmul_both_modes_match_model_linear(M, K, N):
    """int32 mode == QLinear.apply_id; int8 mode == apply_rqt of it
    with the full pre-clip (ragged shapes: the kernel masks edges)."""
    rng = np.random.default_rng(M * K + N)
    x, w, b = _gemm_operands(rng, M, K, N)
    acc = np.asarray(JQLinear(K, N).apply_id(
        {"w_q": jnp.asarray(w), "b_q": jnp.asarray(b)}, jnp.asarray(x)))
    got = int8_matmul(torch.from_numpy(x), _w_kernel_layout(w),
                      torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), acc)
    rq = make_rqt(rng.uniform(1e-4, 1e-3, size=N), 0.5, zp_out=-20,
                  acc_bound=float(K * 127 * 127))
    want = np.asarray(j_apply_rqt(jnp.asarray(acc), rq))
    got8 = int8_matmul(torch.from_numpy(x), _w_kernel_layout(w),
                       torch.from_numpy(b), _tt(rq))
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(got8.numpy(), want)


def test_int8_matmul_plain_wraps_int32():
    """A bias that overflows the accumulator wraps like XLA int32."""
    x = np.full((2, 4), 127, np.int8)
    w = np.full((4, 3), 127, np.int8)
    b = np.full(3, I32_MAX - 10, np.int32)
    want = np.asarray(JQLinear(4, 3).apply_id(
        {"w_q": jnp.asarray(w), "b_q": jnp.asarray(b)}, jnp.asarray(x)))
    got = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).all()


# (K, N) of each GEMM site of granite_3_2b's serving path (wk and wv,
# gate and up share theirs)
GEMM_SITES = {"wq": (2048, 2048), "wk/wv": (2048, 512), "wo": (2048, 2048),
              "gate/up": (2048, 8192), "down": (8192, 2048),
              "head": (2048, 49408)}


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("site", list(GEMM_SITES))
def test_gemm_plan_fills_the_card_at_serving_shapes(site, M):
    """Decode (M 8) and chunked prefill (M 8 x 32): at least one block
    per SM, every split a whole number of K steps with none empty, and
    the GEMV exactly for M <= 16."""
    K, N = GEMM_SITES[site]
    p = gemm_plan(M, N, K)
    assert p.blocks >= SMS
    assert (p.path == "gemv") == (M <= 16)
    assert p.k_split % p.bk == 0
    assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
    row_tiles = -(-M // p.bm) if p.path == "wgmma" else 1
    assert p.blocks == row_tiles * -(-N // p.bn) * p.splits
    if p.path == "gemv":
        assert p.bm >= M


@pytest.mark.parametrize("M", [1, 3, 16, 17, 64, 65, 300])
@pytest.mark.parametrize("K,N", [(16, 7), (48, 520), (160, 136),
                                 (65536, 64), (2048, 40)])
def test_gemm_plan_is_a_valid_launch_at_any_shape(M, K, N):
    """Ragged and odd shapes: a plan the kernel takes (the C entry
    point checks the same), a wgmma block over at most WGMMA_K_MAX
    of K."""
    p = gemm_plan(M, N, K)
    assert (p.path == "gemv") == (M <= 16)
    assert p.splits >= 1 and p.k_split % p.bk == 0
    assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
    if p.path == "gemv":
        assert p.bm in (1, 2, 4, 8, 16) and p.bm >= M
        assert p.bn in (4, 8, 16, 32)
    else:
        assert (p.bm, p.bn) in WGMMA_TILES
        assert p.bm == 64 or M > 64
        assert p.k_split <= WGMMA_K_MAX


@pytest.mark.parametrize("per_channel", [False, True])
def test_requant_matches_pallas_and_ref(per_channel):
    rng = np.random.default_rng(per_channel)
    M, N = 256, 96
    q = rng.integers(-(1 << 26), 1 << 26, size=(M, N)).astype(np.int32)
    eps = rng.uniform(1e-6, 1e-5, size=N) if per_channel else 3e-6
    rq = make_rqt(eps, 0.05, zp_out=7)
    vec = {k: np.broadcast_to(rq[k], (N,)).astype(np.int32)
           for k in ("m", "s0", "lo", "hi")}
    args = [jnp.asarray(vec[k]) for k in ("m", "s0", "lo", "hi")]
    kw = dict(d=int(rq["d"]), zp=int(rq["zp"]))
    want_ref = np.asarray(ref.requant_ref(jnp.asarray(q), *args, **kw))
    want_pl = np.asarray(requant_pallas(jnp.asarray(q), *args, **kw))
    got = requant(torch.from_numpy(q), _tt(rq)).numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pl)


def test_requant_int32_out_matches_apply_rqt():
    """The QAdd branch form: int32 out clipped to +-2^24."""
    rng = np.random.default_rng(4)
    q = rng.integers(-(1 << 14), 1 << 14, size=(3, 5, 64)).astype(np.int32)
    rq = make_rqt(rng.uniform(0.01, 0.05, size=64), 0.06, qmin=-(1 << 24),
                  qmax=1 << 24, acc_bound=float(1 << 16))
    kw = dict(qmin=-(1 << 24), qmax=1 << 24)
    want = np.asarray(j_apply_rqt(jnp.asarray(q), rq, out_dtype=jnp.int32,
                                  **kw))
    got = requant(torch.from_numpy(q), _tt(rq), out_dtype=torch.int32, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _paged_case(rng, *, B, K, group, S, ps, pps, n_pages, pos, tables,
                hd=32, qmax=40):
    H = K * group
    q = rng.integers(-qmax, qmax + 1, size=(B, H, S, hd)).astype(np.int8)
    kp = rng.integers(-qmax, qmax + 1,
                      size=(n_pages + 1, K, ps, hd)).astype(np.int8)
    vp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd)).astype(
        np.int8)
    table = np.asarray(tables, np.int32).reshape(B, pps)
    return q, kp, vp, table, np.asarray(pos, np.int32)


PAGED_CASES = {
    # name: (S, pos per row, table rows) with ps=4, pps=4, 12 pages
    "decode": (1, [0, 5, 15, INACTIVE_POS],
               [[1, 0, 0, 0], [2, 3, 0, 0], [4, 5, 6, 7], [0, 0, 0, 0]]),
    "chunk_in_page": (2, [0, 1, 8, INACTIVE_POS],
                      [[1, 0, 0, 0], [2, 0, 0, 0], [3, 4, 5, 0],
                       [0, 0, 0, 0]]),
    "chunk_across_pages": (6, [2, 3, 7, 0],
                           [[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 0],
                            [9, 10, 0, 0]]),
    "chunk_on_boundary": (4, [0, 4, 8, 12],
                          [[1, 0, 0, 0], [2, 3, 0, 0], [4, 5, 6, 0],
                           [7, 8, 9, 10]]),
    # recycled: stale pages of earlier tenants sit past each row's
    # position and in unallocated table slots
    "recycled_tables": (4, [1, 6, 0, INACTIVE_POS],
                        [[11, 12, 3, 9], [5, 6, 10, 2], [8, 4, 7, 1],
                         [0, 0, 0, 0]]),
}


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_attention_plain_matches_ref(case, group):
    S, pos, tables = PAGED_CASES[case]
    rng = np.random.default_rng(len(case) * 10 + group)
    K = 2
    q, kp, vp, table, pos = _paged_case(
        rng, B=4, K=K, group=group, S=S, ps=4, pps=4, n_pages=12,
        pos=pos, tables=tables)
    scale = np.float32(1.0 / 256.0)
    want = np.asarray(ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), score_scale=scale,
        group=group))
    got = paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.tensor(scale), group=group)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _floats_in(lo_bits, hi_bits, stride):
    """Every `stride`-th float32 whose bits lie in [lo_bits, hi_bits)
    (as signed int32)."""
    return torch.arange(lo_bits, hi_bits, stride,
                        dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_island_exp_is_within_one_ulp_and_zero_below_104():
    """The attention's exp over a sweep of [-104, 0] (every 97th
    float32): at most 1 ulp from the exact value (float64 exp rounded
    once), exactly 1 at 0, and 0.0 for every input below -104 (the
    horizon stop's premise) and at the -1e9 mask."""
    x = _floats_in(-(1 << 31), -(1 << 31) + 0x42D00000 + 1, 97)
    got = island_exp(x).view(torch.int32).to(torch.int64)
    want = torch.exp(x.double()).float().view(torch.int32).to(torch.int64)
    assert int((got - want).abs().max()) <= 1
    assert island_exp(torch.tensor([0.0, -0.0])).tolist() == [1.0, 1.0]
    below = torch.tensor([-104.0001, -200.0, -1e9, NEG_INF - 1e6])
    assert island_exp(below).tolist() == [0.0] * 4


def test_island_exp_equals_a_scalar_float32_evaluation():
    """`island_exp` is one IEEE float32 operation a step: numpy's scalar
    float32 arithmetic, evaluating the kernel's sequence, gives the same
    bits (what makes the plain image the same on any device)."""
    pa = sys.modules["repro_torch.kernels.paged_attention"]
    f = np.float32
    x = _floats_in(-(1 << 31), -(1 << 31) + 0x42D00000 + 1, 100003)
    want = []
    for v in x.numpy():
        if v < f(-104.0):
            want.append(f(0.0))
            continue
        k = f(np.rint(f(v * f(pa._LOG2E))))
        r = f(f(v - f(k * f(pa._LN2_C1))) - f(k * f(pa._LN2_C2)))
        p = f(pa._EXP_POLY[0])
        for c in pa._EXP_POLY[1:]:
            p = f(f(p * r) + f(c))
        y = f(f(f(p * f(r * r)) + r) + f(1.0))
        ki = int(k)
        k1 = ki >> 1
        s1 = np.array([(k1 + 127) << 23], np.int32).view(np.float32)[0]
        s2 = np.array([(ki - k1 + 127) << 23], np.int32).view(np.float32)[0]
        want.append(f(f(y * s1) * s2))
    np.testing.assert_array_equal(island_exp(x).view(torch.int32).numpy(),
                                  np.array(want, np.float32).view(np.int32))


@pytest.mark.parametrize("fn,args", [
    ("int8_matmul", None), ("requant", None), ("paged_attention", None)])
def test_wrappers_raise_off_cpu_instead_of_falling_back(fn, args):
    """A tensor that is neither on the CPU nor on a CUDA device (the
    meta device here) reaches no plain version: the wrapper raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "int8_matmul":
            int8_matmul(torch.empty((4, 8), dtype=torch.int8, **meta),
                        torch.empty((8, 2), dtype=torch.int8, **meta),
                        torch.empty((2,), dtype=torch.int32, **meta))
        elif fn == "requant":
            requant(torch.empty((4, 8), dtype=torch.int32, **meta), {})
        else:
            paged_attention(
                torch.empty((1, 2, 1, 32), dtype=torch.int8, **meta),
                torch.empty((3, 1, 4, 32), dtype=torch.int8, **meta),
                torch.empty((3, 1, 4, 32), dtype=torch.int8, **meta),
                torch.empty((1, 2), dtype=torch.int32, **meta),
                torch.empty((1,), dtype=torch.int32, **meta),
                torch.empty((), dtype=torch.float32, **meta), group=2)


def test_lane_sum_follows_the_kernels_order():
    """Lane l of 32 adds t = l, l + 32, ... from 0 in float32, then a
    xor butterfly; emulated here one float32 add at a time."""
    rng = np.random.default_rng(3)
    p = rng.random((3, 100), dtype=np.float32) * np.float32(1e-3)
    p[:, ::7] = rng.random((3, 15), dtype=np.float32)
    want = np.empty((3, 1), np.float32)
    for r in range(3):
        part = [np.float32(0.0)] * 32
        for t in range(100):
            part[t % 32] = np.float32(part[t % 32] + p[r, t])
        for o in (16, 8, 4, 2, 1):
            part = [np.float32(part[l] + part[l ^ o]) for l in range(32)]
        assert len(set(part)) == 1
        want[r, 0] = part[0]
    got = _lane_sum(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)


def _image_inputs():
    # 4 x 8 x 8 x 128 = 32768 entries, so check_image allows 8 moves
    rng = np.random.default_rng(11)
    q, kp, vp, table, pos = _paged_case(
        rng, B=4, K=2, group=4, S=8, ps=16, pps=8, n_pages=32,
        pos=[0, 40, 100, 120], tables=rng.permutation(
            np.arange(1, 33)).reshape(4, 8))
    return (torch.from_numpy(q), torch.from_numpy(kp),
            torch.from_numpy(table), torch.from_numpy(pos),
            torch.tensor(np.float32(1.0 / 2048.0)))


@pytest.mark.parametrize("wrong", ["round_down", "inexact_division",
                                   "one_entry_by_two"])
def test_image_check_rejects_a_wrong_kernels_image(wrong):
    q, kp, table, pos, scale = _image_inputs()
    probs = attention_probs(q, kp, table, pos, scale, group=4)
    good = torch.round(probs * 127.0).to(torch.int8)
    if wrong == "round_down":
        bad = torch.floor(probs * 127.0).to(torch.int8)
    elif wrong == "inexact_division":
        # probabilities off by 2^-9 of themselves, as a fast exp or
        # reciprocal could leave them
        bad = torch.round(probs * (1 + 2.0 ** -9) * 127.0).to(torch.int8)
    else:
        bad = good.clone()
        bad.view(-1)[int(torch.argmax(good))] -= 2
    with pytest.raises(AssertionError, match="probability quanta moved"):
        check_image(bad, good, wrong)


def test_image_check_passes_a_few_single_moves():
    q, kp, table, pos, scale = _image_inputs()
    good = torch.round(attention_probs(q, kp, table, pos, scale, group=4)
                       * 127.0).to(torch.int8)
    assert check_image(good, good) == 0
    moved = good.clone()
    flat = moved.view(-1)
    live = torch.nonzero(flat > 0).flatten()[:8]
    flat[live] -= 1
    assert check_image(moved, good) == 8
    flat[torch.nonzero(flat > 0).flatten()[8]] += 1
    with pytest.raises(AssertionError):
        check_image(moved, good)


def _owned_lane_sum(p, warps):
    """numpy emulation of the int8 kernel's row sum (csrc pass 1) for
    one 16-row tile and its `warps` warps: per staged tile of 32 *
    warps keys, warp w's lane (g, t) puts p of rows g and g + 8, keys
    32 w + 8 n + 2 t + e (its C fragment), into the tile's f32 rows;
    the warp that owns a row (16 / warps rows each) adds column l of
    each 32-key chunk to the row's partial l, chunk after chunk; then
    the xor butterfly over the 32 lanes.  (With the logits kept, the
    rows hold every tile at once and the owner walks the same chunks in
    the same order.)  One float32 add at a time.  p: (16, T) float32 ->
    (16,) float32."""
    rows, T = p.shape
    bt = 32 * warps
    rpw = 16 // warps
    part = np.zeros((16, 32), np.float32)
    for j in range(-(-T // bt)):
        stage = np.full((16, bt), np.nan, np.float32)
        for w in range(warps):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for n in range(4):
                    for e in range(4):
                        key = j * bt + 32 * w + 8 * n + 2 * t + (e & 1)
                        row = g if e < 2 else g + 8
                        stage[row, 32 * w + 8 * n + 2 * t + (e & 1)] = (
                            p[row, key] if key < T else np.float32(0.0))
        for w in range(warps):
            for x in range(rpw):
                row = rpw * w + x
                for c in range(warps):
                    part[row] = part[row] + stage[row, 32 * c:32 * c + 32]
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lane ^ o]
    assert (part == part[:, :1]).all()
    return part[:, 0]


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("T", [16, 100, 512])
def test_kernel_partial_ownership_equals_lane_sum(warps, T):
    """The kernel's split of the 32 partials over warps and lanes (4
    warps on each of two row tiles, or 8 on one) adds each partial's
    keys in increasing t, so its sum is `_lane_sum`'s bit for bit, for
    T no multiple of the tile too."""
    rng = np.random.default_rng(T + warps)
    p = rng.random((16, T), dtype=np.float32) * np.float32(1e-3)
    p[:, ::9] = rng.random((16, len(range(0, T, 9))), dtype=np.float32)
    want = _lane_sum(torch.from_numpy(p)).numpy()[:, 0]
    np.testing.assert_array_equal(_owned_lane_sum(p, warps), want)


def _softmax_parts(q, kp, table, pos, scale, group, lim=None):
    """The plain version's row max, `_lane_sum` and image, over all T
    keys (lim None) or with slot b's keys cut at lim[b] (the kernel's
    horizon stop): the max over keys < lim only, p = 0 past it."""
    S = q.shape[2]
    kh = gathered_view(kp, table, group)
    T = kh.shape[2]
    s = torch.matmul(q.double(), kh.double().transpose(-1, -2))
    lg = s.to(torch.int32).to(torch.float32) * scale
    q_pos = pos.long()[:, None] + torch.arange(S)
    keep = torch.arange(T)[None, None, :] <= q_pos[:, :, None]
    lg = lg + torch.where(keep, 0.0, NEG_INF)[:, None]
    lim = [T] * len(pos) if lim is None else lim
    live = torch.arange(T)[None, :] < torch.as_tensor(lim)[:, None]
    live = live[:, None, None, :]
    m = torch.where(live, lg, -torch.inf).amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(lg - m), 0.0)
    total = _lane_sum(p)
    return m, total, torch.round(p / total * 127.0)


def _extreme_case(T=64, S=1, hd=32):
    """Decode rows (S 1), q all -128; keys at or before each slot's
    position +127 (scores -128 * 127 * hd, the lowest), keys after it
    -128 (scores +128 * 128 * hd, the highest): masked logits as high
    against the visible ones as int8 operands can put them."""
    B, K, group, ps = 2, 1, 2, 8
    pps = T // ps
    pos = torch.tensor([5, 20], dtype=torch.int32)
    q = torch.full((B, K * group, S, hd), -128, dtype=torch.int8)
    kp = torch.full((B * pps + 1, K, ps, hd), -128, dtype=torch.int8)
    table = torch.arange(1, B * pps + 1, dtype=torch.int32).reshape(B, pps)
    for b in range(B):
        for key in range(int(pos[b]) + 1):  # visible to every row
            kp[table[b, key // ps], 0, key % ps] = 127
    lim = [min(T, int(pos[b]) + S) for b in range(B)]
    return q, kp, table, pos, group, lim, hd


def _scale_at(a, hd):
    """The float32 score scale with |scale| * 128 * 128 * hd = a."""
    return float(np.float32(a / (16384.0 * hd)))


@pytest.mark.parametrize("scale", [1.0 / 2048.0, -1.0 / 64.0, "edge"])
def test_horizon_stop_is_exact_under_its_guard(scale):
    """Keys past the tile's last row's horizon dropped: the row max,
    the lane sum and the image equal the plain version's over all T bit
    for bit, at the engine's scale, a negative one, and the largest
    scale the guard admits (on the extreme case, there)."""
    if scale == "edge":
        q, kp, table, pos, group, lim, hd = _extreme_case()
        scale = _scale_at(STOP_GUARD, hd)
    else:
        rng = np.random.default_rng(5)
        q, kp, _, table, pos = (torch.from_numpy(a) for a in _paged_case(
            rng, B=4, K=2, group=2, S=8, ps=16, pps=8, n_pages=32,
            pos=[0, 15, 61, 100], tables=rng.permutation(
                np.arange(1, 33)).reshape(4, 8), qmax=127))
        group, hd = 2, 32
        lim = [min(128, int(p) + 8) for p in pos]
    assert horizon_stop(scale, hd)
    sc = torch.tensor(np.float32(scale))
    m, total, img = _softmax_parts(q, kp, table, pos, sc, group)
    assert torch.equal(img, torch.round(attention_probs(
        q, kp, table, pos, sc, group=group) * 127.0))
    m_s, total_s, img_s = _softmax_parts(q, kp, table, pos, sc, group, lim)
    assert torch.equal(m_s, m) and torch.equal(total_s, total)
    assert torch.equal(img_s, img)


def test_horizon_stop_planted_case_just_outside_the_guard():
    """At |scale| * 128 * 128 * hd = 5.1e8, just above the guard, a
    masked key's logit (+A - 1e9) beats the visible keys' (-A): over
    all T the row's mass sits past the horizon, and stopping there
    would give another image.  The guard turns the stop off."""
    q, kp, table, pos, group, lim, hd = _extreme_case()
    scale = _scale_at(5.1e8, hd)
    assert not horizon_stop(scale, hd)
    sc = torch.tensor(np.float32(scale))
    m, _, img = _softmax_parts(q, kp, table, pos, sc, group)
    m_s, _, img_s = _softmax_parts(q, kp, table, pos, sc, group, lim)
    assert (m > m_s).all() and not torch.equal(img_s, img)
    past = torch.arange(img.shape[-1])[None, :] >= torch.as_tensor(
        lim)[:, None]
    assert int((img * past[:, None, None, :]).sum()) > 0


# (B, K, group, S, hd, ps, pps): the engine's and chip_smoke.py's
# shapes (full granite: 8 slots, 8 kv heads, group 4, hd 64, pages of
# 16; T 512 and 4096), the card tests' (every hd, group, S and T of
# test_paged_attention_mma_on_card), llama4_maverick's group 5 over 8 kv
# heads at hd 128 and the small recycled-table ones
PLAN_SHAPES = (
    [(8, 8, 4, S, 64, 16, pps) for S in (1, 32) for pps in (32, 256)]
    + [(8, 8, 5, S, 128, 16, pps) for S in (1, 4, 32) for pps in (32, 256)]
    + [(3, 2, grp, S, hd, 16, pps) for hd in (32, 64, 128)
       for grp in (1, 2, 4, 8) for S in (1, 4, 32) for pps in (32, 256)]
    + [(4, 2, 4, S, hd, 4, 4) for S in (1, 4) for hd in (32, 64, 128)])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("B,K,group,S,hd,ps,pps", PLAN_SHAPES)
def test_paged_plan_is_a_valid_launch(B, K, group, S, hd, ps, pps, packed):
    """Every shape the port runs, over int8 pools or int4-packed ones,
    takes the tensor-core kernel within 220 KB of shared memory: a
    compiled (warps, rows) shape with a 32-key chunk a warp, a ring of
    2-4 tiles, one 16-row tile a block exactly where 16-row blocks would
    leave SMs idle, the logits kept in shared memory while the block's
    rows below M take at most 80 KB of them.  Packed pools take the
    int8 mode's launch with the ring's rows halved (hd/2 bytes, 16 apart
    more) and two 16-byte unpack tables: no limit on S*T of their own
    (S 32 over T 4096 keeps neither logits nor an image of S*T)."""
    p = paged_plan(B, K, group, S, hd, ps, pps, packed)
    T, M = ps * pps, group * S
    assert p.kernel == "mma" and (p.warps, p.rows) in MMA_SHAPES
    assert p.keys == 32 * p.warps * 16 // p.rows
    assert (p.rows == 16) == (B * K * -(-M // 16) < 132)
    assert p.blocks == B * K * -(-M // p.rows)
    kept = 4 * min(p.rows, M) * (-(-T // p.keys) * p.keys + 8)
    assert p.logits == ("shared" if kept <= 80 * 1024 else "recomputed")
    keep = p.logits == "shared"
    assert 2 <= p.stages <= 4
    assert p.smem == _mma_smem(hd, p.warps, p.rows, p.stages, M, T, pps,
                               keep, packed)
    assert p.smem <= _SMEM_LIMIT
    # the P.V reduction reuses the space at the start
    assert p.smem >= p.warps * 16 * (hd + 8) * 4
    if packed:
        # the int8 mode's launch, its ring as deep or deeper
        p8 = paged_plan(B, K, group, S, hd, ps, pps)
        assert p._replace(stages=p8.stages, smem=p8.smem) == p8
        assert p.stages >= p8.stages
        # the int8 layout at this depth with hd/2 bytes fewer a ring row,
        # plus the tables
        int8_same = _mma_smem(hd, p.warps, p.rows, p.stages, M, T, pps,
                              keep)
        slots = p.stages * (1 if keep else 2) * p.keys
        assert p.smem == max(64 * p.warps * (hd + 8),
                             int8_same - slots * hd // 2 + 32)
