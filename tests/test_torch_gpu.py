"""The port's CUDA kernels against their plain versions, on the card.

These tests carry the `gpu` marker and skip without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on
a GPU machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

It covers both paths of the int8 GEMM (the GEMV and the wgmma
pipeline, split K or not) at every serving shape and ragged ones, a
planted layout, split K with int8 out looped 50 times, the shared
workspace across shapes, and the refusal of K not a multiple of 16;
the requant kernel's three forms (apply_rqt with heads-to-rows, the
QAdd, the MLP's gate) at the serving path's chunk and decode shapes,
scalar-path shapes, per-channel and wrapping tables, int8 and int32 a,
a misaligned input, each launch counted once on its form, and a
2-layer engine whose launches by form are (1, 1, 2) a layer and step,
the paged attention on a recycled table with GQA
group 4 and a parked row in both pool modes (int8, and int4-packed
with per-head unpack operands whose m, s0 and d differ from head to
head), a planted wrong unpack that the packed check rejects, the
tensor-core kernel over int8 pools and over int4-packed ones at every
head width, group 1-8, S 1/4/32 and T 512/4096 (horizons on and inside
page boundaries, pos 0, a parked row, PAGE_NULL entries past the
horizons, pages of 12 keys) with 0 quanta moved and each launch on its
pool mode's counter, a planted score scale that turns its horizon stop
off on the device, and a planted layout (one-hot queries, V distinct
by key and column) that shows a wrong fragment, hd order, key
permutation or nibble lookup, and the
quantized flash attention on both of its kernels (every head width,
bkv 128, 64, 32 and 48, GQA, ragged S_q and q_offset, not causal) with
0 quanta moved, a planted case whose output differs between two KV
partitions, held at each, and a planted score scale under which
skipping the causal blocks past a tile would change the output, on both
kernels.  The shapes llama3_2_3b and chatglm3_6b give the kernels: the
GEMM at every site of both, the paged attention at hd 128 with GQA
group 3 over 8 kv heads and group 16 over 2 (both pool modes, S 1/4/32,
T 512/4096), the requant forms at their widths; and 2-layer engines on
the card with telemetry on and off (equal tokens, equal to the CPU's)
and a warmup that leaves the pools byte-equal.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.intmath import unpack_int4
from repro_torch.core.requant import apply_rqt, make_rqt
from repro_torch.kernels import (
    int8_matmul, int8_matmul_plain, paged_attention, paged_attention_kv4,
    paged_attention_plain, quant_flash_attention, quant_flash_attention_plain,
    requant, requant_add, requant_add_plain, requant_gate,
    requant_gate_plain, requant_plain,
)
from repro_torch.kernels.int8_matmul import (
    _WORKSPACE, GEMV_COLS, WGMMA_TILES, GemmPlan, gemm_plan,
)
from repro_torch.kernels.paged_attention import (
    check_image, check_kernel, gathered_view, horizon_stop, kv4_unpack,
    staged_unpack_rq,
)
from repro_torch.kernels.quant_attention import qfa_plan
from repro_torch.layers.attention import INACTIVE_POS, PAGE_NULL

# the module (the package exports its function under the same name)
_gemm_module = sys.modules["repro_torch.kernels.int8_matmul"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _rq(tree):
    return {k: torch.from_numpy(np.array(v)).cuda() for k, v in tree.items()}


# (K, N) of every GEMM site of granite_3_2b's serving path: wq and wo,
# wk and wv, gate and up, down, the head
MAIN_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
           (2048, 49408)]
GEMM_CASES = (
    [(M, K, N) for M in (1, 8, 16, 17, 64, 256, 300) for K, N in MAIN_KN]
    + [(M, K, N) for M in (1, 8, 17, 300)
       for K, N in ((48, 520), (96, 136), (160, 520))]
    + [(8, 2048, 512), (16, 64, 40), (256, 2048, 2048), (200, 96, 136),
       (37, 160, 66), (5, 48, 7)])


def _gemm_operands(rng, M, K, N, ld_pad=0):
    """x (M, K) as a row slice of an (M, K + ld_pad) buffer, w stored
    (N, K) (both drawn on the card from a seed of `rng`), and a bias
    whose columns 0, 3, ... sit at 2^31 - 1 and 1, 4, ... at -2^31, so
    that most of those columns wrap."""
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    xb = torch.randint(-128, 128, (M, K + ld_pad), dtype=torch.int8,
                       device="cuda", generator=g)
    w = torch.randint(-128, 128, (N, K), dtype=torch.int8, device="cuda",
                      generator=g).t()
    b = rng.integers(-(1 << 20), 1 << 20, size=N).astype(np.int64)
    b[0::3] = 2 ** 31 - 1
    b[1::3] = -2 ** 31
    return xb[:, :K], w, torch.from_numpy(b.astype(np.int32)).cuda()


def _gemm_tables(rng, K, N):
    """int32 out, and int8 out through scalar and per-column tables."""
    bound = float(K * 127 * 127)
    return [None,
            _rq(make_rqt(float(rng.uniform(1e-5, 4e-5)), 0.05,
                         acc_bound=bound)),
            _rq(make_rqt(rng.uniform(1e-5, 4e-5, size=N), 0.05,
                         acc_bound=bound))]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", GEMM_CASES)
def test_int8_matmul_on_card(M, K, N):
    """Both paths at every serving (K, N) and ragged ones, both modes,
    scalar and per-column tables, contiguous and row-sliced x (ldx > K),
    wrapping biases: equal to the plain version."""
    _need_card()
    rng = np.random.default_rng(M + K + N)
    for pad in (0, 48):
        x, w, b = _gemm_operands(rng, M, K, N, pad)
        assert x.stride(0) == K + pad
        for r in _gemm_tables(rng, K, N):
            got = int8_matmul(x, w, b, r)
            want = int8_matmul_plain(x, w, b, r)
            assert got.dtype == want.dtype
            assert torch.equal(got, want), (pad, r is None)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(8, 2048, 512), (256, 2048, 2048),
                                   (300, 160, 136), (256, 8192, 2048),
                                   (256, 2048, 8192)])
def test_int8_matmul_planted_layout_on_card(M, K, N):
    """Known products that show a layout fault as a pattern: a single
    non-zero K column of x (inside and across 128-byte swizzle atoms),
    and identity-block weights (out[r, n] = x[r, n % K]); int32 out
    against the product itself, and int8 out through per-column tables
    whose columns all differ, against the plain version."""
    _need_card()
    rng = np.random.default_rng(7)
    b = torch.from_numpy(
        rng.integers(-1000, 1000, size=N).astype(np.int32)).cuda()
    col = torch.from_numpy(
        (np.arange(N) % 251 - 125).astype(np.int8)).cuda()
    rows = torch.from_numpy(
        (np.arange(M) % 255 - 127).astype(np.int8)).cuda()
    eps = np.linspace(1e-5, 4e-5, N)
    rq = _rq(make_rqt(eps, 0.05, acc_bound=float(K * 127 * 127)))
    # at least 136 distinct (m, s0) column tables, all N up to 136
    assert len(set(zip(*(rq[k].cpu().tolist()
                         for k in ("m", "s0"))))) >= min(N, 136)
    for k in sorted({0, 17, 127, 128, K // 2 + 33, K - 1}):
        x = torch.zeros((M, K), dtype=torch.int8, device="cuda")
        x[:, k] = rows
        wt = torch.zeros((N, K), dtype=torch.int8, device="cuda")
        wt[:, k] = col
        want = rows.int()[:, None] * col.int()[None, :] + b
        assert torch.equal(int8_matmul(x, wt.t(), b), want), k
        assert torch.equal(int8_matmul(x, wt.t(), b, rq),
                           int8_matmul_plain(x, wt.t(), b, rq)), k
    x = torch.from_numpy(
        rng.integers(-128, 128, size=(M, K)).astype(np.int8)).cuda()
    wt = torch.zeros((N, K), dtype=torch.int8, device="cuda")
    n = torch.arange(N, device="cuda")
    wt[n, n % K] = 1
    assert torch.equal(int8_matmul(x, wt.t(), b), x.int()[:, n % K] + b)
    assert torch.equal(int8_matmul(x, wt.t(), b, rq),
                       int8_matmul_plain(x, wt.t(), b, rq))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(256, 2048, 512), (8, 2048, 512),
                                   (100, 2048, 136)])
def test_int8_matmul_split_k_int8_out_50_loops_on_card(M, K, N):
    """Split K with int8 out: the epilogue must wait for every partial.
    50 launches on the same inputs, each equal to the plain version."""
    _need_card()
    assert gemm_plan(M, N, K).splits > 1
    rng = np.random.default_rng(50)
    x, w, b = _gemm_operands(rng, M, K, N)
    rq = _gemm_tables(rng, K, N)[2]
    want = int8_matmul_plain(x, w, b, rq)
    outs = [int8_matmul(x, w, b, rq) for _ in range(50)]
    for i, got in enumerate(outs):
        assert torch.equal(got, want), i


# every tile and GEMV width the plan can pick, with and without split K
FORCED_PLANS = ([("wgmma", bm, bn, splits) for bm, bn in WGMMA_TILES
                 for splits in (1, 3)]
                + [("gemv", 8, bn, splits) for bn in GEMV_COLS
                   for splits in (1, 2)])


@pytest.mark.gpu
@pytest.mark.parametrize("path,bm,bn,splits", FORCED_PLANS)
def test_int8_matmul_every_plan_on_card(path, bm, bn, splits, monkeypatch):
    """Each launch plan the kernel takes, forced on a ragged shape (N
    520, M 200 or 5, K 2048), both modes: equal to the plain version."""
    _need_card()
    M, K, N = (200 if path == "wgmma" else 5), 2048, 520
    bk = 128 if path == "wgmma" else 512
    k_split = -(-K // (splits * bk)) * bk
    tiles = (-(-M // bm) if path == "wgmma" else 1) * -(-N // bn)
    plan = GemmPlan(path, bm, bn, bk, splits, k_split, tiles * splits)
    monkeypatch.setattr(_gemm_module, "gemm_plan", lambda *a: plan)
    rng = np.random.default_rng(11)
    x, w, b = _gemm_operands(rng, M, K, N)
    for r in _gemm_tables(rng, K, N):
        assert torch.equal(int8_matmul(x, w, b, r),
                           int8_matmul_plain(x, w, b, r)), r is None


@pytest.mark.gpu
def test_int8_matmul_shared_workspace_back_to_back_on_card():
    """Split-K launches of different shapes back to back on one stream
    share the workspace; each stays exact and the tile counters are
    zero again after them."""
    _need_card()
    rng = np.random.default_rng(3)
    shapes = [(256, 2048, 512), (8, 2048, 512), (17, 2048, 2048),
              (256, 8192, 2048), (100, 2048, 136), (16, 2048, 512),
              (1, 8192, 512)]
    cases = []
    for M, K, N in shapes:
        assert gemm_plan(M, N, K).splits > 1
        x, w, b = _gemm_operands(rng, M, K, N)
        for r in _gemm_tables(rng, K, N)[::2]:
            cases.append((x, w, b, r))
    outs = [int8_matmul(*c) for c in cases + cases[::-1]]
    for c, got in zip(cases + cases[::-1], outs):
        assert torch.equal(got, int8_matmul_plain(*c))
    torch.cuda.synchronize()
    assert _WORKSPACE
    for _, count in _WORKSPACE.values():
        assert not count.any()


@pytest.mark.gpu
def test_int8_matmul_refuses_unaligned_k_on_card():
    _need_card()
    x = torch.zeros((4, 30), dtype=torch.int8, device="cuda")
    w = torch.zeros((7, 30), dtype=torch.int8, device="cuda").t()
    b = torch.zeros(7, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul(x, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True])
def test_requant_on_card(per_channel):
    _need_card()
    rng = np.random.default_rng(per_channel)
    q = torch.randint(-(1 << 20), 1 << 20, (64, 96), dtype=torch.int32,
                      device="cuda")
    eps = rng.uniform(1e-6, 1e-5, size=96) if per_channel else 3e-6
    rq = _rq(make_rqt(eps, 0.05, zp_out=3))
    assert torch.equal(requant(q, rq), apply_rqt(q, rq))
    rq32 = _rq(make_rqt(eps, 0.05, qmin=-(1 << 24), qmax=1 << 24))
    kw = dict(qmin=-(1 << 24), qmax=1 << 24, out_dtype=torch.int32)
    assert torch.equal(requant(q, rq32, **kw), apply_rqt(q, rq32, **kw))


def _card_rqt(rng, N, kind, ratio, *, zp=0, int32_out=False,
              acc_bound=float(1 << 24)):
    """Requant tables on the card: `scalar` or `channel` from make_rqt
    (eps_in / eps_out about `ratio`), `wrap` with per-channel m in
    [2^28, 2^31) and s0 0 so the staged product wraps in int32."""
    if kind == "wrap":
        m = rng.integers(1 << 28, 1 << 31, size=N)
        return _rq({"m": (m - (1 << 32) * (m >= 1 << 31)).astype(np.int32),
                    "d": np.int32(20), "s0": np.zeros(N, np.int32),
                    "lo": np.full(N, -(1 << 20), np.int32),
                    "hi": np.full(N, 1 << 20, np.int32), "zp": np.int32(zp)})
    eps = ratio * (rng.uniform(0.5, 1.5, size=N) if kind == "channel"
                   else float(rng.uniform(0.5, 1.5)))
    kw = dict(qmin=-(1 << 24), qmax=1 << 24) if int32_out else {}
    return _rq(make_rqt(eps, 1.0, zp_out=zp, acc_bound=acc_bound, **kw))


def _counted(form, fn):
    """fn() with exactly one requant launch, on `form`."""
    before = requant.launches, dict(requant.by_form)
    out = fn()
    assert requant.launches == before[0] + 1
    assert requant.by_form.get(form, 0) == before[1].get(form, 0) + 1
    return out


# the serving path's chunk and decode shapes (8 slots, 32 heads, hd 64,
# d 2048, d_ff 8192, chunks of 32) and shapes off 16-element vectors
RQT_CASES = [((8, 32, 32, 64), "scalar", True, False),
             ((8, 32, 1, 64), "scalar", True, False),
             ((2, 3, 5, 24), "channel", True, False),
             ((2, 4, 3, 32), "wrap", True, False),
             ((256, 2048), "channel", False, False),
             ((8, 32, 2048), "channel", False, True),
             ((3, 37, 29), "scalar", False, False),
             ((7, 100), "channel", False, True),
             ((256, 2048), "wrap", False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,heads,out32", RQT_CASES)
def test_requant_form_rqt_on_card(shape, kind, heads, out32):
    _need_card()
    rng = np.random.default_rng(len(shape) + 7 * shape[-1])
    q = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, size=shape)
                         .astype(np.int32)).cuda()
    rq = _card_rqt(rng, shape[-1], kind, 1 / 128, zp=0 if out32 else 3,
                   int32_out=out32)
    kw = dict(heads_to_rows=heads)
    if out32:
        kw.update(qmin=-(1 << 24), qmax=1 << 24, out_dtype=torch.int32)
    got = _counted("rqt_heads" if heads else "rqt",
                   lambda: requant(q, rq, **kw))
    assert torch.equal(got, requant_plain(q, rq, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 4])
def test_requant_misaligned_input_takes_the_scalar_path_on_card(offset):
    _need_card()
    rng = np.random.default_rng(offset)
    flat = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, size=(
        8 * 2048 + offset,)).astype(np.int32)).cuda()
    q = flat[offset:].view(8, 2048)
    rq = _card_rqt(rng, 2048, "channel", 1 / 128)
    got = _counted("rqt", lambda: requant(q, rq))
    assert torch.equal(got, requant_plain(q, rq))


ADD_CARD_CASES = [((8, 32, 2048), True, "scalar", "channel"),
                  ((8, 1, 2048), True, "scalar", "channel"),
                  ((8, 32, 2048), False, "channel", "channel"),
                  ((8, 1, 2048), False, "scalar", "scalar"),
                  ((5, 3, 100), True, "scalar", "channel"),
                  ((5, 3, 37), True, "scalar", "scalar"),
                  ((8, 1, 2048), False, "wrap", "wrap"),
                  ((4, 64), True, "channel", "wrap")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,a_int8,kind_a,kind_b", ADD_CARD_CASES)
def test_requant_form_add_on_card(shape, a_int8, kind_a, kind_b):
    _need_card()
    rng = np.random.default_rng(shape[0] + 3 * shape[-1] + a_int8)
    N = shape[-1]
    a = (rng.integers(-128, 128, size=shape).astype(np.int8) if a_int8
         else rng.integers(-(1 << 17), 1 << 17, size=shape).astype(np.int32))
    b = rng.integers(-(1 << 17), 1 << 17, size=shape).astype(np.int32)
    kw = dict(int32_out=True, acc_bound=float(1 << 16))
    t = {"rq_a": _card_rqt(rng, N, kind_a, 0.5 if a_int8 else 1e-3, **kw),
         "rq_b": _card_rqt(rng, N, kind_b, 1e-3, **kw),
         "zp_a": torch.tensor(5, dtype=torch.int32).cuda(),
         "zp_b": torch.tensor(-7, dtype=torch.int32).cuda()}
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got = _counted("add", lambda: requant_add(a, b, t))
    assert torch.equal(got, requant_add_plain(a, b, t))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", [
    ((256, 8192), "scalar"), ((8, 8192), "scalar"), ((7, 333), "channel"),
    ((8, 8192), "wrap"), ((16, 96), "channel")])
def test_requant_form_gate_on_card(shape, kind):
    _need_card()
    rng = np.random.default_rng(shape[0] + shape[-1])
    s_pre, s_u = (torch.from_numpy(rng.integers(-128, 128, size=shape)
                                   .astype(np.int8)).cuda() for _ in "ab")
    lut = torch.from_numpy(rng.integers(-128, 128, size=256)
                           .astype(np.int8)).cuda()
    zp_g = torch.tensor(-11, dtype=torch.int32).cuda()
    rq = _card_rqt(rng, shape[-1], kind, 1 / 256, zp=2)
    got = _counted("gate", lambda: requant_gate(s_pre, s_u, lut, zp_g, rq))
    assert torch.equal(got, requant_gate_plain(s_pre, s_u, lut, zp_g, rq))


@pytest.mark.gpu
def test_engine_requant_launches_by_form_on_card():
    """A 2-layer reduced granite on the card: every step launches the
    requant kernel once heads-to-rows (ctx_rqt), once for the gate and
    twice for the QAdds in each layer, and nothing else; its tokens
    equal the CPU's (plain versions)."""
    _need_card()
    import copy

    from repro_torch import kernels
    from repro_torch.launch.serve import deploy_model, ragged_requests
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    lm, t_gpu = deploy_model("granite_3_2b", reduced=True, max_seq=64,
                             seed=0, device="cuda")
    _, t_cpu = deploy_model("granite_3_2b", reduced=True, max_seq=64,
                            seed=0, device="cpu")
    reqs = ragged_requests(5, lm.cfg.vocab, np.random.default_rng(1),
                           prompt_lo=5, prompt_hi=40, gen=5)

    def serve(tables, device):
        eng = ServingEngine(lm, tables, ServingConfig(
            n_slots=4, max_len=64, page_size=8, n_pages=40, device=device,
            scheduler=SchedulerConfig(prefill_chunk=8)))
        for r in reqs:
            eng.submit(copy.deepcopy(r))
        done = eng.run_until_drained()
        return {c.req_id: list(c.tokens) for c in done}, eng.stats()["steps"]

    kernels.reset_launch_counts()
    tok, steps = serve(t_gpu, "cuda")
    L = lm.cfg.n_layers * steps
    assert requant.by_form == {"rqt_heads": L, "gate": L, "add": 2 * L}
    assert requant.launches == 4 * L
    assert tok == serve(t_cpu, "cpu")[0]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4])
def test_paged_attention_on_card(S):
    _need_card()
    rng = np.random.default_rng(S)
    B, K, group, hd, ps, pps, n_pages = 4, 2, 4, 32, 4, 4, 12
    H = K * group
    q = torch.from_numpy(rng.integers(
        -40, 41, size=(B, H, S, hd)).astype(np.int8)).cuda()
    kp = torch.from_numpy(rng.integers(
        -40, 41, size=(n_pages + 1, K, ps, hd)).astype(np.int8)).cuda()
    vp = torch.from_numpy(rng.integers(
        -128, 128, size=(n_pages + 1, K, ps, hd)).astype(np.int8)).cuda()
    table = torch.tensor([[11, 12, 3, 9], [5, 6, 10, 2], [8, 4, 7, 1],
                          [0, 0, 0, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([1, 6, 0, INACTIVE_POS], dtype=torch.int32,
                       device="cuda")
    scale = torch.tensor(1.0 / 256.0, device="cuda")
    qp = torch.empty((B, H, S, pps * ps), dtype=torch.int8, device="cuda")
    got = paged_attention(q, kp, vp, table, pos, scale, group=group,
                          qp_out=qp)
    want, want_qp = paged_attention_plain(q, kp, vp, table, pos, scale,
                                          group=group, return_qp=True)
    check_image(qp, want_qp, f"S={S}")
    # the integer P.V over the kernel's own image, exactly
    pv = torch.matmul(qp.double(), gathered_view(vp, table, group).double())
    assert torch.equal(got, pv.to(torch.int32))
    if torch.equal(qp, want_qp):
        assert torch.equal(got, want)


def _packed_inputs(rng, S, device):
    B, K, group, hd, ps, pps, n_pages = 4, 2, 4, 32, 4, 4, 12
    H = K * group
    q = rng.integers(-40, 41, size=(B, H, S, hd)).astype(np.int8)
    kp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd // 2))
    vp = rng.integers(-128, 128, size=(n_pages + 1, K, ps, hd // 2))
    table = np.array([[11, 12, 3, 9], [5, 6, 10, 2], [8, 4, 7, 1],
                      [0, 0, 0, 0]], np.int32)
    pos = np.array([1, 6, 0, INACTIVE_POS], np.int32)
    args = [torch.from_numpy(a).to(device) for a in (
        q, kp.astype(np.int8), vp.astype(np.int8), table, pos)]
    scale = torch.tensor(1.0 / 64.0, device=device)
    rq = staged_unpack_rq(K).to(device)
    return args, scale, rq, torch.roll(rq, 1, dims=1), group


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4])
def test_paged_attention_kv4_on_card(S):
    _need_card()
    args, scale, k_rq, v_rq, group = _packed_inputs(
        np.random.default_rng(S), S, "cuda")
    B, H = args[0].shape[:2]
    T = args[3].shape[1] * args[1].shape[2]
    qp = torch.empty((B, H, S, T), dtype=torch.int8, device="cuda")
    n = paged_attention_kv4.launches
    got = paged_attention(*args, scale, group=group, k_rq=k_rq, v_rq=v_rq,
                          qp_out=qp)
    assert paged_attention_kv4.launches == n + 1
    assert check_kernel(got, qp, *args, scale, group=group, k_rq=k_rq,
                        v_rq=v_rq, what=f"kv4 S={S}") == (0, 0)


def floor_unpack(pool, rq):
    """A wrong unpack: one floor of x * m / 2^d instead of the formula's
    (x >> s0) * m >> (d - s0)."""
    m, s0, lo, hi, d, zp = (r.to(torch.int64).reshape(-1, 1, 1) for r in rq)
    x = torch.minimum(torch.maximum(unpack_int4(pool).to(torch.int64), lo),
                      hi)
    return (torch.div(x * m, 2 ** d, rounding_mode="floor") + zp).clamp(
        -128, 127).to(torch.int8)


@pytest.mark.gpu
def test_packed_check_rejects_a_planted_wrong_unpack_on_card():
    _need_card()
    args, scale, k_rq, v_rq, group = _packed_inputs(
        np.random.default_rng(9), 4, "cuda")
    q, kp, vp, table, pos = args
    bad, bad_qp = paged_attention_plain(
        q, floor_unpack(kp, k_rq), floor_unpack(vp, v_rq), table, pos,
        scale, group=group, return_qp=True)
    with pytest.raises(AssertionError):
        check_kernel(bad, bad_qp, *args, scale, group=group, k_rq=k_rq,
                     v_rq=v_rq, what="planted")
    good, good_qp = paged_attention_plain(
        *args, scale, group=group, k_rq=k_rq, v_rq=v_rq, return_qp=True)
    assert check_kernel(good, good_qp, *args, scale, group=group,
                        k_rq=k_rq, v_rq=v_rq) == (0, 0)
    assert not torch.equal(floor_unpack(kp, k_rq), kv4_unpack(kp, k_rq))


def _mma_inputs(seed, hd, group, S, T, *, ps=16, K=2, qmax=40,
                packed=False):
    """Pools on the card for the tensor-core kernel: 4 slots, pos 0
    (slot 0); a last row's horizon on a page's end (slot 1); inside a
    page (slot 2); parked at INACTIVE_POS (slot 3).  The table is a
    recycled permutation whose entries past each active slot's last
    horizon are PAGE_NULL (slot 0) or stale pages of other tenants.
    int8 pools hold keys in [-qmax, qmax]; int4-packed ones (`packed`)
    any bytes, with per-head unpack operands (`staged_unpack_rq`, V's
    rolled by one head).  -> (q, k_pool, v_pool, table, pos), and the
    keywords k_rq / v_rq (packed) or none."""
    rng = np.random.default_rng(seed)
    B, pps = 4, T // ps
    H = K * group
    n_pool = B * pps + 1
    q = rng.integers(-qmax, qmax + 1, size=(B, H, S, hd)).astype(np.int8)
    if packed:
        kp = rng.integers(-128, 128, size=(n_pool, K, ps, hd // 2))
    else:
        kp = rng.integers(-qmax, qmax + 1, size=(n_pool, K, ps, hd))
    vp = rng.integers(-128, 128, size=kp.shape)
    table = rng.permutation(np.arange(1, n_pool)).reshape(B, pps)
    pos = np.array([0, max(0, ps * (pps // 3) - S), ps * (pps // 2) + 7,
                    INACTIVE_POS], np.int32)
    table[0, -(-S // ps):] = PAGE_NULL
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        q, kp.astype(np.int8), vp.astype(np.int8), table.astype(np.int32),
        pos)]
    kw = {}
    if packed:
        rq = staged_unpack_rq(K).cuda()
        kw = dict(k_rq=rq, v_rq=torch.roll(rq, 1, dims=1))
    return args, kw


def _mma_launch(args, scale, group, kw, what):
    """One launch of the tensor-core kernel with its image, held at 0
    quanta moved and the plain output, counted on the pool mode's own
    counter.  -> the image."""
    q, table = args[0], args[3]
    B, H, S = q.shape[:3]
    T = table.shape[1] * args[1].shape[2]
    qp = torch.empty((B, H, S, T), dtype=torch.int8, device="cuda")
    n, n4 = paged_attention.launches, paged_attention_kv4.launches
    got = paged_attention(*args, scale, group=group, qp_out=qp, **kw)
    assert (paged_attention.launches, paged_attention_kv4.launches) == (
        (n, n4 + 1) if kw else (n + 1, n4))
    assert check_kernel(got, qp, *args, scale, group=group, what=what,
                        **kw) == (0, 0)
    return qp


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("T", [512, 4096])
@pytest.mark.parametrize("S", [1, 4, 32])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_paged_attention_mma_on_card(hd, group, S, T, packed):
    """The tensor-core kernel over int8 pools, or int4-packed ones,
    equals the plain version: 0 probability quanta moved, the same int32
    output, one launch on the pool mode's counter."""
    _need_card()
    args, kw = _mma_inputs(hd * 1000 + group * 100 + S + T, hd, group, S,
                           T, packed=packed)
    scale = torch.tensor(1.0 / 1024.0, device="cuda")
    assert horizon_stop(1.0 / 1024.0, hd)
    _mma_launch(args, scale, group, kw,
                f"hd={hd} group={group} S={S} T={T} packed={packed}")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S", [1, 32])
def test_paged_attention_mma_odd_page_size_on_card(S, packed):
    """Pages of 12 keys (no power of two: the kernel's page lookup
    divides instead of shifting) over T 504: equal to the plain
    version, 0 quanta moved, in both pool modes."""
    _need_card()
    args, kw = _mma_inputs(12 + S, 64, 4, S, 504, ps=12, packed=packed)
    scale = torch.tensor(1.0 / 1024.0, device="cuda")
    _mma_launch(args, scale, 4, kw, f"ps=12 S={S} packed={packed}")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", ["random", "extreme"])
def test_paged_attention_mma_guard_off_on_card(case, packed):
    """Planted score scales past the horizon stop's guard, read by the
    kernel from the device tensor: it scores all T keys and equals the
    plain version over all T.  "extreme": decode rows with q -128,
    keys +127 but the three after each slot's position, which are -128,
    at |scale| * 128 * 128 * hd = 5.1e8: those masked keys hold the
    row's max and its image, so stopping at the horizon would change
    the output.  Packed, those key images come from nibbles 7 and -8
    through a K column that clips 7 * 19 to 127 and -8 * 19 to -128."""
    _need_card()
    hd, group, S, T = 64, 4, (4 if case == "random" else 1), 512
    args, kw = _mma_inputs(77, hd, group, S, T, qmax=127, packed=packed)
    q, kp, vp, table, pos = args
    if case == "random":
        scale_f = 1000.0
    else:
        scale_f = float(np.float32(5.1e8 / (16384.0 * hd)))
        top, bottom = (0x77, -0x78) if packed else (127, -128)
        if packed:
            kw["k_rq"][:] = torch.tensor(
                [19, 0, -8, 7, 0, 0], dtype=torch.int32,
                device="cuda")[:, None]
        q.fill_(-128)
        kp.fill_(top)
        pos[3] = 300  # no parked row here: every slot has a horizon
        for b in range(4):
            pages = table[b].long()
            for key in range(int(pos[b]) + 1, int(pos[b]) + 4):
                kp[pages[key // 16], :, key % 16] = bottom
    assert not horizon_stop(scale_f, hd)
    scale = torch.tensor(scale_f, dtype=torch.float32, device="cuda")
    qp = _mma_launch(args, scale, group, kw, f"{case} packed={packed}")
    if case == "extreme":  # the image lies past every horizon
        past = torch.arange(T, device="cuda")[None, :] > pos.long()[:, None]
        assert bool((qp.sum(dim=(1, 2), dtype=torch.int64)
                     * past).sum(dim=1).gt(0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hd,group,S", [(64, 4, 32), (128, 2, 4),
                                        (32, 8, 1)])
def test_paged_attention_mma_planted_layout_on_card(hd, group, S, packed):
    """Planted: each query row one-hot in a head dimension of its own
    (64 at d = (head * S + i) % hd), V distinct by key and column
    (int8: (7 key + 13 col) % 251 - 125 over the logical view; packed:
    random nibbles, rows that differ at once), a scale that makes each
    row's image peak on a few keys.  A wrong score fragment, hd order,
    key permutation (sigma), nibble lookup or V transpose moves the
    image or the output."""
    _need_card()
    T, ps = 512, 16
    args, kw = _mma_inputs(hd + group + S, hd, group, S, T, qmax=127,
                           packed=packed)
    q, kp, vp, table, pos = args
    B, H = q.shape[:2]
    q.zero_()
    for h in range(H):
        for i in range(S):
            q[:, h, i, (h * S + i) % hd] = 64
    if not packed:
        key = torch.arange(T, device="cuda")
        col = torch.arange(hd, device="cuda")
        vals = ((7 * key[:, None] + 13 * col[None, :]) % 251 - 125).to(
            torch.int8)
        for b in range(B):
            pages = table[b].long()
            vp[pages] = vals.reshape(T // ps, ps, hd)[:, None].expand(
                -1, vp.shape[1], -1, -1)
    scale = torch.tensor(1.0 / 256.0, device="cuda")
    qp = _mma_launch(args, scale, group, kw, f"planted layout {packed}")
    assert int((qp == 127).sum()) < qp.numel() // 2


def _qfa_inputs(seed, hd, S_q, S_kv, n_rep, B=2, K=2):
    rng = np.random.default_rng(seed)
    H = K * n_rep
    return (torch.from_numpy(rng.integers(
        -127, 128, size=(B, h, s, hd)).astype(np.int8)).cuda()
        for h, s in ((H, S_q), (K, S_kv), (K, S_kv)))


# (hd, S_q, S_kv, causal, n_rep, q_offset, bkv): every head width; bkv
# 128, 64 and 32 on the tensor-core kernel and 48 on the CUDA-core one
# (qfa_plan); n_rep 1, 2, 4, 8; q_offsets that are no multiple of the
# 16-row tile; S_q no multiple of 16; not causal
QFA_CARD_CASES = [
    (64, 128, 128, True, 1, 0, 128), (128, 128, 256, True, 1, 0, 128),
    (192, 128, 128, False, 1, 0, 128), (64, 256, 384, True, 1, 0, 128),
    (64, 100, 256, True, 4, 156, 128), (32, 128, 256, True, 1, 0, 128),
    (32, 77, 384, False, 4, 0, 64), (64, 256, 384, True, 4, 37, 64),
    (128, 90, 256, True, 2, 21, 64), (192, 100, 256, True, 4, 9, 64),
    (64, 100, 384, True, 4, 37, 48), (128, 64, 384, False, 2, 0, 48),
    (192, 50, 256, True, 8, 3, 32), (64, 300, 512, True, 8, 5, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,S_q,S_kv,causal,n_rep,q_offset,bkv",
                         QFA_CARD_CASES)
def test_quant_flash_attention_on_card(hd, S_q, S_kv, causal, n_rep,
                                       q_offset, bkv):
    _need_card()
    B, K = 2, 2
    H = K * n_rep
    q, k, v = _qfa_inputs(hd + S_q + bkv, hd, S_q, S_kv, n_rep, B, K)
    kw = dict(score_scale=1e-4, eps_ctx=0.01, causal=causal,
              q_offset=q_offset, n_rep=n_rep, bkv=bkv)
    n = quant_flash_attention.launches
    got = quant_flash_attention(q, k, v, **kw)
    assert quant_flash_attention.launches == n + 1
    want = quant_flash_attention_plain(q, k, v, **kw)
    assert got.shape == (B, H, S_q, hd) and got.dtype == torch.int8
    assert check_image(got, want, f"quant_flash_attention hd={hd}",
                       unit="ctx") == 0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_quant_flash_attention_honours_the_kv_partition():
    """Planted: inputs whose plain output differs between bkv 64 and bkv
    128 (the per-block image depends on each block's running max); the
    kernel matches the plain version at each, so it neither merges nor
    splits the KV blocks it is given."""
    _need_card()
    q, k, v = _qfa_inputs(5, 64, 64, 256, 2, B=1)
    kw = dict(score_scale=1e-4, eps_ctx=0.01, causal=True, q_offset=192,
              n_rep=2)
    want = {bkv: quant_flash_attention_plain(q, k, v, bkv=bkv, **kw)
            for bkv in (64, 128)}
    assert int((want[64] != want[128]).sum()) > 0
    for bkv in (64, 128):
        got = quant_flash_attention(q, k, v, bkv=bkv, **kw)
        assert torch.equal(got, want[bkv]), bkv


@pytest.mark.gpu
@pytest.mark.parametrize("bkv", [128, 48])
def test_quant_flash_attention_computes_masked_blocks_when_it_must(bkv):
    """Planted: at score_scale 1e5 a row's visible logits can all lie
    below -1e9, so its running max stays -1e9 and the masked entries
    past its last key give qp = 127; skipping those blocks would change
    the output (asserted on the plain version over the first keys
    only).  `qfa_plan` turns skipping off, and both kernels (bkv 128
    on the tensor cores, 48 on the CUDA cores) match the plain version
    over every block."""
    _need_card()
    hd, S_q, S_kv, n_rep = 64, 64, 384, 2
    q, k, v = _qfa_inputs(7, hd, S_q, S_kv, n_rep, B=1)
    kw = dict(score_scale=1e5, eps_ctx=0.01, causal=True, q_offset=0,
              n_rep=n_rep, bkv=bkv)
    plan = qfa_plan(n_rep, hd, 128, bkv, True, 1e5)
    assert not plan.skip and plan.path == ("mma" if bkv == 128 else "simt")
    want = quant_flash_attention_plain(q, k, v, **kw)
    seen = -(-S_q // bkv) * bkv  # keys of the blocks a row can see
    skipped = quant_flash_attention_plain(
        q, k[:, :, :seen].contiguous(), v[:, :, :seen].contiguous(), **kw)
    assert int((want != skipped).sum()) > 0
    got = quant_flash_attention(q, k, v, **kw)
    assert torch.equal(got, want)


# -- the shapes llama3_2_3b and chatglm3_6b give the kernels ---------------
# (K, N) of every GEMM site: wq and wo, wk and wv, gate and up, down, the
# head; llama3_2_3b (d 3072, 24/8 heads of 128, d_ff 8192, vocab 128256),
# then chatglm3_6b (d 4096, 32/2 heads of 128, d_ff 13696, vocab 65024)
CONFIG_KN = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
             (3072, 128256),
             (4096, 4096), (4096, 256), (4096, 13696), (13696, 4096),
             (4096, 65024)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 17, 256, 300])
@pytest.mark.parametrize("K,N", CONFIG_KN)
def test_int8_matmul_config_sites_on_card(K, N, M):
    """Both paths at every GEMM site of the two configs, both modes,
    scalar and per-column tables, wrapping biases: equal to the plain
    version."""
    _need_card()
    rng = np.random.default_rng(M * 7 + K + N)
    x, w, b = _gemm_operands(rng, M, K, N)
    for r in _gemm_tables(rng, K, N):
        got = int8_matmul(x, w, b, r)
        want = int8_matmul_plain(x, w, b, r)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (gemm_plan(M, N, K), r is None)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("T", [512, 4096])
@pytest.mark.parametrize("S", [1, 4, 32])
@pytest.mark.parametrize("group,K", [(3, 8), (16, 2)])
def test_paged_attention_mma_config_groups_on_card(group, K, S, T, packed):
    """The tensor-core kernel at the configs' heads, hd 128: GQA group 3
    over 8 kv heads (llama3_2_3b's 24/8) and group 16 over 2
    (chatglm3_6b's 32/2), both pool modes: 0 quanta moved, the plain
    output, one launch on the pool mode's counter."""
    _need_card()
    args, kw = _mma_inputs(7000 + group * 100 + S + T, 128, group, S, T,
                           K=K, packed=packed)
    scale = torch.tensor(1.0 / 2048.0, device="cuda")
    _mma_launch(args, scale, group, kw,
                f"hd=128 group={group} K={K} S={S} T={T} packed={packed}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 24, 32, 128), (8, 24, 1, 128),
                                   (8, 32, 32, 128), (8, 32, 1, 128)])
def test_requant_ctx_rqt_config_heads_on_card(shape):
    _need_card()
    rng = np.random.default_rng(shape[1] + shape[2])
    q = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, size=shape)
                         .astype(np.int32)).cuda()
    rq = _card_rqt(rng, shape[-1], "scalar", 1 / 128)
    got = _counted("rqt_heads",
                   lambda: requant(q, rq, heads_to_rows=True))
    assert torch.equal(got, requant_plain(q, rq, heads_to_rows=True))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind_a", [
    ((8, 32, 3072), "scalar"), ((8, 1, 3072), "scalar"),
    ((8, 32, 4096), "scalar"), ((8, 1, 4096), "channel")])
def test_requant_form_add_config_widths_on_card(shape, kind_a):
    """The QAdd at d 3072 and 4096, int8 residual a, per-channel rq_b."""
    _need_card()
    rng = np.random.default_rng(shape[1] + shape[2])
    kw = dict(int32_out=True, acc_bound=float(1 << 16))
    t = {"rq_a": _card_rqt(rng, shape[-1], kind_a, 0.5, **kw),
         "rq_b": _card_rqt(rng, shape[-1], "channel", 1e-3, **kw),
         "zp_a": torch.tensor(5, dtype=torch.int32).cuda(),
         "zp_b": torch.tensor(-7, dtype=torch.int32).cuda()}
    a = torch.from_numpy(rng.integers(-128, 128, size=shape)
                         .astype(np.int8)).cuda()
    b = torch.from_numpy(rng.integers(-(1 << 17), 1 << 17, size=shape)
                         .astype(np.int32)).cuda()
    got = _counted("add", lambda: requant_add(a, b, t))
    assert torch.equal(got, requant_add_plain(a, b, t))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 8192), (8, 8192), (256, 13696),
                                   (8, 13696)])
def test_requant_form_gate_config_widths_on_card(shape):
    """The MLP's gate (LUT, gate product, h_rqt) at d_ff 8192
    (llama3_2_3b) and 13696 (chatglm3_6b), chunk and decode rows."""
    _need_card()
    rng = np.random.default_rng(shape[0] + 3 * shape[1])
    s_pre, s_u = (torch.from_numpy(rng.integers(-128, 128, size=shape)
                                   .astype(np.int8)).cuda() for _ in "ab")
    lut = torch.from_numpy(rng.integers(-128, 128, size=256)
                           .astype(np.int8)).cuda()
    zp_g = torch.tensor(-11, dtype=torch.int32).cuda()
    rq = _card_rqt(rng, shape[-1], "scalar", 1 / 256, zp=2)
    got = _counted("gate", lambda: requant_gate(s_pre, s_u, lut, zp_g, rq))
    assert torch.equal(got, requant_gate_plain(s_pre, s_u, lut, zp_g, rq))


def _engines_on_card_and_cpu(arch, kv_bits, telemetry=None):
    """A 2-layer reduced `arch` deployed on the card and on the CPU, one
    engine on each."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    out = []
    for device in ("cuda", "cpu"):
        lm, t = deploy_model(arch, reduced=True, max_seq=64, seed=0,
                             device=device)
        out.append(ServingEngine(lm, t, ServingConfig(
            n_slots=4, max_len=64, page_size=8, n_pages=40, device=device,
            kv_bits=kv_bits, telemetry=telemetry if device == "cuda"
            else None, scheduler=SchedulerConfig(prefill_chunk=8))))
    return out


def _serve_all(eng, reqs):
    import copy

    for r in reqs:
        eng.submit(copy.deepcopy(r))
    return {c.req_id: list(c.tokens) for c in eng.run_until_drained()}


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ["granite_3_2b", "llama3_2_3b",
                                  "chatglm3_6b"])
def test_engine_telemetry_is_bit_neutral_on_card(arch, kv_bits):
    """A 2-layer engine on the card with telemetry on gives the tokens of
    one with it off, and of the CPU's; every step has its record and
    every request its lifecycle events."""
    _need_card()
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving import Telemetry

    tel = Telemetry(profile_annotations=True)
    on, cpu = _engines_on_card_and_cpu(arch, kv_bits, tel)
    off, _ = _engines_on_card_and_cpu(arch, kv_bits)
    reqs = ragged_requests(5, on.lm.cfg.vocab, np.random.default_rng(2),
                           prompt_lo=5, prompt_hi=40, gen=5)
    tok = _serve_all(on, reqs)
    assert tok == _serve_all(off, reqs) == _serve_all(cpu, reqs)
    assert len(tel.steps) == on.stats()["steps"]
    assert sum(e["event"] == "emit" for e in tel.events) == 25
    assert sum(e["event"] == "finish" for e in tel.events) == 5


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_warmup_leaves_the_pools_byte_equal_on_card(kv_bits):
    """After a drained workload, warmup on the card leaves every page a
    request can hold byte-equal (its parked rows write only the
    PAGE_NULL trash page), its pools equal the CPU engine's after the
    same sequence, and the next window's tokens equal the CPU's."""
    _need_card()
    from repro_torch.launch.serve import ragged_requests

    card, cpu = _engines_on_card_and_cpu("llama3_2_3b", kv_bits)
    reqs = ragged_requests(5, card.lm.cfg.vocab, np.random.default_rng(3),
                           prompt_lo=5, prompt_hi=40, gen=5)
    for eng in (card, cpu):
        _serve_all(eng, reqs)
    before = [card.arena.caches[kv].clone() for kv in ("k", "v")]
    card.warmup()
    cpu.warmup()
    for kv, b in zip(("k", "v"), before):
        assert torch.equal(card.arena.caches[kv][:, 1:], b[:, 1:])
        assert torch.equal(card.arena.caches[kv].cpu(), cpu.arena.caches[kv])
    for eng in (card, cpu):
        eng.reset_stats()
    assert _serve_all(card, reqs) == _serve_all(cpu, reqs)
    assert card.stats()["n_completed"] == len(reqs)
