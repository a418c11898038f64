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
and a warmup that leaves the pools byte-equal.  The prefix cache's
copy-on-write page copy on the card in both pool modes equals the same
copy on the CPU and leaves every other page untouched, and a 2-layer
engine on the card with the prefix cache and a scripted preemption
gives the CPU engine's tokens, counters and pools; the paged
attention's exp (`island_exp`) gives the CPU's bits on the card.
Engines on both devices get one table set, calibrated and deployed on
the card (`deploy_model`) and moved to the CPU; the two devices'
calibrations are compared on their own (each range within 1e-4 of
its span), and the float forward is shown to run on the card.  At
dispatch depth 1 the card's tokens equal depth 0's and the CPU's, and
under torch's sync debug mode a step waits only at its harvest.
musicgen_medium's and nemotron_4_340b's shapes: the paged attention at
hd 192 with GQA group 12 over 8 kv heads (S 1/32, T 512/4096, both pool
modes) and at group 1 over 24 kv heads (hd 64), an unsupported head
width raising on the card, the requant kernel's act form (GELU's LUT,
squared ReLU's square and rqt2, per-channel and wrapping) at d_ff 6144
and 73728, the GEMM at their sites up to K 73728, and 2-layer engines
of both on the card equal to the CPU's with their launches by form.
The MoE family's shapes: the grouped int8 GEMM at olmoe_1b_7b's expert
sites (C 4, 40 and 80 over 64 experts) and ragged and split-K ones,
every table form, exact and one launch a call; the paged attention over
the slot arena's pools (pages of 512 keys, one a slot) at decode and at
B=1 whole-prompt prefills up to 512 rows; and a reduced olmoe engine in
exact mode over both arenas, the card equal to the CPU.  The paper's
CNN (`NemoCNN`): the GEMM at its conv and head shapes (K 32, 144, 288
and 1024; N 16, 32, 64 and 10; GEMV and wgmma), the requant kernel
per channel at N 16, 32 and 64, the threshold count by binary search
against the comparison count (repeated thresholds), and the full-width
model's ID forward in its three BN modes on 32 images, the card equal
to the CPU block by block with every conv and the head on the GEMM
kernel.  The write-then-gather attention: its two products on the
grouped GEMM at granite's attention shapes (S 32 and 1, T 512), a
padded T and hd 192, exact and counted by shape; `int_softmax` the
CPU's image byte for byte on wrapping inputs without a host sync; a
2-layer engine under `attn_softmax="int"` equal to the CPU's with no
paged-kernel launch, and `paged_kernel=False` equal to the default.
The ssm family: the scan island's fixed float32 sequences (exp, log,
log1p, softplus) and the scan core at L 1-256 with and without a state
give the CPU's bits on the card, and a reduced falcon_mamba_7b engine
over either arena gives the CPU's tokens and conv / h state, with its
launches by kernel and requant form.  FakeQuantized training: the PACT
straight-through functions give the CPU's images and masked gradients
bit for bit on the card, and reduced granite_3_2b's FQ loss, gradients
and three `launch.train.build` steps track the CPU's within 1e-3 /
2e-2.
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
from repro_torch.models.lm import params_to_torch, tables_to

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
    t_cpu = tables_to(t_gpu, "cpu")  # one calibrated table set
    reqs = ragged_requests(5, lm.cfg.vocab, np.random.default_rng(1),
                           prompt_lo=5, prompt_hi=40, gen=5)

    def serve(tables, device):
        eng = ServingEngine(lm, tables, ServingConfig(
            n_slots=4, max_len=64, paged=True, page_size=8, n_pages=40,
            device=device, scheduler=SchedulerConfig(prefill_chunk=8)))
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
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("T", [512, 4096])
@pytest.mark.parametrize("S", [1, 4, 32])
def test_paged_attention_mma_group5_on_card(S, T, packed):
    """The tensor-core kernel at llama4_maverick's heads, hd 128: GQA
    group 5 over 8 kv heads (40/8), both pool modes: 0 quanta moved, the
    plain output, one launch on the pool mode's counter."""
    _need_card()
    args, kw = _mma_inputs(7500 + S + T, 128, 5, S, T, K=8, packed=packed)
    scale = torch.tensor(1.0 / 2048.0, device="cuda")
    _mma_launch(args, scale, 5, kw,
                f"hd=128 group=5 K=8 S={S} T={T} packed={packed}")


@pytest.mark.gpu
@pytest.mark.parametrize("C,K,N", [(4, 5120, 8192), (4, 8192, 5120),
                                   (8, 5120, 8192)])
def test_int8_matmul_grouped_llama4_experts_on_card(C, K, N):
    """The grouped GEMM at llama4_maverick's 128 experts, one launch:
    gate / up (K 5120, N 8192) and down (K 8192, N 5120), C 4 and 8,
    int32 out and with per-(expert, channel) tables, exactly as the plain
    version."""
    _need_card()
    from repro_torch.core.requant import make_rqt
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )

    E = 128
    rng = np.random.default_rng(C * 10 + K)
    g = torch.Generator(device="cuda").manual_seed(C + K)
    x = torch.randint(-128, 128, (1, E, C, K), dtype=torch.int8,
                      device="cuda", generator=g)
    w = torch.randint(-128, 128, (E, N, K), dtype=torch.int8, device="cuda",
                      generator=g).transpose(1, 2)
    per = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
           for k, v in make_rqt(rng.uniform(1e-5, 4e-5, size=(E, N)), 0.05,
                                acc_bound=K * 127.0 * 127.0).items()}
    for rqt in (None, per):
        n = int8_matmul_grouped.launches
        got = int8_matmul_grouped(x, w, rqt)
        assert int8_matmul_grouped.launches == n + 1
        want = int8_matmul_grouped_plain(x, w, rqt)
        assert got.dtype == want.dtype and torch.equal(got, want), (
            C, K, N, rqt is None)
        del got, want
    del x, w
    torch.cuda.empty_cache()


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


def _engines_on_card_and_cpu(arch, kv_bits, telemetry=None,
                             dispatch_depth=0, paged_kernel=None):
    """A 2-layer reduced `arch` deployed (calibrated) on the card, its
    one table set moved to the CPU, and one engine on each."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    lm, t_gpu = deploy_model(arch, reduced=True, max_seq=64, seed=0,
                             device="cuda")
    tables = {"cuda": t_gpu, "cpu": tables_to(t_gpu, "cpu")}
    return [ServingEngine(lm, tables[device], ServingConfig(
        n_slots=4, max_len=64, paged=True, page_size=8, n_pages=40,
        device=device,
        kv_bits=kv_bits, dispatch_depth=dispatch_depth,
        paged_kernel=paged_kernel,
        telemetry=telemetry if device == "cuda" else None,
        scheduler=SchedulerConfig(prefill_chunk=8)))
        for device in ("cuda", "cpu")]


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


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cow_page_copy_on_card(kv_bits):
    """A write into a registered page copy-on-writes it: on the card the
    new page holds the old page's bytes on both pools (int4-packed at
    kv_bits 4), every other page is untouched, and the pools equal the
    CPU arena's after the same split."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serving import PagedArena

    lm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=64)
    arenas = [PagedArena(lm, 2, 64, 8, 12, device=dev, kv_bits=kv_bits,
                         prefix_cache=True, keep_pages=12)
              for dev in ("cuda", "cpu")]
    g = torch.Generator().manual_seed(kv_bits)
    init = {kv: torch.randint(-128, 128, tuple(arenas[1].caches[kv].shape),
                              dtype=torch.int8, generator=g)
            for kv in ("k", "v")}
    toks = np.arange(24, dtype=np.int32)
    for a in arenas:
        for kv in ("k", "v"):
            a.caches[kv].copy_(init[kv])
        # chunked admissions (written 0): the prefix cache's path
        s0 = a.alloc(0, 24, 30, written=0, tokens=toks)
        a.touch_range(s0, 0, 24)
        a.advance(s0, 24)
        a.register_prefix(s0, toks, 24)
        s1 = a.alloc(1, 24, 30, written=0, tokens=toks)
        assert int(a.lengths[s1]) == 23
        old = int(a.page_table[s1, 2])
        a.touch(s1, 23)
        new = int(a.page_table[s1, 2])
        assert new != old and a.cow_splits == 1
    for kv in ("k", "v"):
        want = init[kv].clone()
        want[:, new] = want[:, old]
        got = arenas[0].caches[kv].cpu()
        assert torch.equal(got, want)
        assert torch.equal(got, arenas[1].caches[kv])


class _EvictNewestDecode:
    """FCFS plus one scripted eviction at plan call `at`: the most
    recently admitted decode with at least 2 tokens of budget left."""

    name = "scripted"

    def __init__(self, at):
        from repro_torch.serving import FCFSPolicy

        self.inner, self.at, self.calls, self.fired = FCFSPolicy(), at, 0, 0

    def plan(self, view):
        plan = self.inner.plan(view)
        live = [d for d in view.active if d.budget_left >= 2]
        if self.calls == self.at and live:
            plan.preempt.append(
                max(live, key=lambda d: (d.admit_time, d.req_id)).slot)
            self.fired += 1
        self.calls += 1
        return plan


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefix_cache_and_preemption_on_card(kv_bits):
    """A 2-layer reduced granite engine on the card with the prefix cache
    on (a shared 16-token prompt, its aligned-exact twin) and one
    scripted preemption gives the CPU engine's tokens, prefix and
    preemption counters and pools, and drains clean."""
    _need_card()
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serving import (
        Request, SchedulerConfig, ServingConfig, ServingEngine,
    )

    rng = np.random.default_rng(5)
    pre = rng.integers(0, 256, size=(16,))
    reqs = [Request(np.concatenate([pre, rng.integers(0, 256, size=(n,))]),
                    8) for n in (5, 11, 3)] + [Request(pre.copy(), 8)]
    lm, t_gpu = deploy_model("granite_3_2b", reduced=True, max_seq=64,
                             seed=0, device="cuda")
    tables = {"cuda": t_gpu, "cpu": tables_to(t_gpu, "cpu")}
    out = []
    for device in ("cuda", "cpu"):
        t = tables[device]
        pol = _EvictNewestDecode(5)
        eng = ServingEngine(lm, t, ServingConfig(
            n_slots=4, max_len=64, paged=True, page_size=8, n_pages=40,
            device=device,
            kv_bits=kv_bits, policy=pol, prefix_cache=True,
            cache_keep_pages=8, scheduler=SchedulerConfig(prefill_chunk=16)))
        tok = _serve_all(eng, reqs)
        st = eng.stats()
        out.append((tok, pol.fired, {k: st[k] for k in (
            "prefix_hits", "prefix_misses", "prefix_hit_pages", "cow_splits",
            "warm_evictions", "n_preempts", "steps")},
            [eng.arena.caches[kv].cpu() for kv in ("k", "v")]))
        assert int((eng.arena.refcount != 0).sum()) == 0
        assert eng.arena.committed_pages == 0
    (gt, gf, gs, gp), (ct, cf, cs, cp) = out
    assert gt == ct and gf == cf == 1 and gs == cs
    assert gs["cow_splits"] >= 1 and gs["n_preempts"] == 1
    assert gs["prefix_hit_pages"] >= 2
    for a, b in zip(gp, cp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_island_exp_card_equals_cpu():
    """The paged attention's exp (`island_exp`, in its plain version) on
    the card gives the CPU's bits on every 7th float32 of [-104, 0] and
    on the values next to its cutoff."""
    _need_card()
    from repro_torch.kernels.paged_attention import island_exp

    lo, n = -(1 << 31), 0x42D00000 + 1
    for a in range(lo, lo + n, 7 << 24):
        x = torch.arange(a, min(a + (7 << 24), lo + n), 7,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)
        assert torch.equal(island_exp(x.cuda()).cpu(), island_exp(x))
    edge = torch.tensor([-104.0, -103.99999, -104.00001, -87.33655, 0.0])
    assert torch.equal(island_exp(edge.cuda()).cpu(), island_exp(edge))



CALIB_TOL = 1e-4  # of the span: the card's f32 GEMMs against the CPU's


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_2b", "llama3_2_3b",
                                  "chatglm3_6b"])
def test_calibrate_card_equals_cpu_on_card(arch):
    """The FullPrecision forward of the entry point's calibration sample
    on the card and on the CPU, from the same init_np params: the same
    names in the same order, each lo / hi within CALIB_TOL of the CPU's
    span (their float32 matmuls sum in different orders)."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import calibration_sample
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config(arch).reduced(), max_seq=64)
    p = lm.init_np(0)
    sample = calibration_sample(lm.cfg.vocab, 64)
    card = lm.calibrate(p, sample, device="cuda")
    cpu = lm.calibrate(p, sample, device="cpu")
    assert list(card.hi) == list(cpu.hi) and len(cpu.hi) > 30
    for name in cpu.hi:
        span = max(cpu.hi[name] - cpu.lo[name], 1e-6)
        assert abs(card.hi[name] - cpu.hi[name]) <= CALIB_TOL * span, name
        assert abs(card.lo[name] - cpu.lo[name]) <= CALIB_TOL * span, name


@pytest.mark.gpu
def test_calibrate_runs_on_the_card_on_card():
    """deploy_model's float forward runs where it was asked to: its
    observations read tensors on the card (none of them moves to the
    CPU first), and the calibrated tables differ from DEFAULT_RANGES'."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.launch.serve import calibration_sample
    from repro_torch.models.lm import DecoderLM

    seen = set()

    class Spy(Calibrator):
        def observe(self, name, x):
            seen.add(x.device.type)
            super().observe(name, x)

    lm = DecoderLM(get_config("granite_3_2b").reduced(), max_seq=64)
    p = lm.init_np(0)
    p_card = params_to_torch(p, "cuda")
    calib = Spy()
    x = lm.embed_in(p_card, torch.from_numpy(
        calibration_sample(lm.cfg.vocab, 64)).cuda(), calib=calib)
    x = lm.apply(p_card, x, calib=calib)
    assert seen == {"cuda"} and x.is_cuda
    cal = lm.deploy(p, calib)
    free = lm.deploy(p, None)
    assert not np.array_equal(cal["segments"][0]["mlp"]["u_rqt"]["m"],
                              free["segments"][0]["mlp"]["u_rqt"]["m"])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_async_depth1_tokens_equal_depth0_on_card(kv_bits):
    """A 2-layer calibrated granite engine at dispatch_depth 1 on the
    card: tokens equal depth 0's on the card and depth 1's on the CPU
    (one table set), the queue empty after the drain, and the step
    records' queue depth 1 while a step is in flight."""
    _need_card()
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving import Telemetry

    tel = Telemetry()
    card1, cpu1 = _engines_on_card_and_cpu("granite_3_2b", kv_bits, tel,
                                           dispatch_depth=1)
    card0, _ = _engines_on_card_and_cpu("granite_3_2b", kv_bits)
    reqs = ragged_requests(6, card1.lm.cfg.vocab, np.random.default_rng(4),
                           prompt_lo=5, prompt_hi=40, gen=6)
    tok = _serve_all(card1, reqs)
    assert tok == _serve_all(card0, reqs) == _serve_all(cpu1, reqs)
    assert card1.queue.pending == 0
    assert card1.stats()["dispatch_depth"] == 1
    assert {s["queue_depth"] for s in tel.steps} == {0, 1}


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1])
def test_async_step_waits_only_at_the_harvest_on_card(depth):
    """With torch's sync debug mode at "error" (it raises on a blocking
    copy, .item() and a stream or device synchronize; torch calls the
    mode a prototype that does not see every sync), a warmed 2-layer
    engine on the card serves a workload with the prefix cache and a
    scripted preemption to the drain: the only wait in a step is the
    harvest's CUDA event on the token vector's pinned copy."""
    _need_card()
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serving import (
        Request, SchedulerConfig, ServingConfig, ServingEngine,
    )

    lm, t = deploy_model("granite_3_2b", reduced=True, max_seq=64, seed=0,
                         device="cuda")
    rng = np.random.default_rng(5)
    pre = rng.integers(0, 256, size=(16,))
    reqs = [Request(np.concatenate([pre, rng.integers(0, 256, size=(n,))]),
                    8) for n in (5, 11, 3)] + [Request(pre.copy(), 8)]
    pol = _EvictNewestDecode(5)
    eng = ServingEngine(lm, t, ServingConfig(
        n_slots=4, max_len=64, paged=True, page_size=8, n_pages=40,
        device="cuda",
        dispatch_depth=depth, policy=pol, prefix_cache=True,
        cache_keep_pages=8, scheduler=SchedulerConfig(prefill_chunk=16)))
    eng.warmup()
    torch.cuda.synchronize()
    waits = []
    harvest = eng._harvest

    def counted(rec):
        waits.append(rec.done is not None)
        harvest(rec)

    eng._harvest = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.zeros(1, device="cuda").cpu()  # the mode is on
        tok = _serve_all(eng, reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(tok) == len(reqs) and pol.fired == 1
    assert eng.stats()["n_preempts"] == 1
    assert waits and all(waits)


# -- musicgen_medium and nemotron_4_340b: LayerNorm, the ungated MLP, MHA
# and hd 192 -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("T", [512, 4096])
@pytest.mark.parametrize("S", [1, 32])
def test_paged_attention_mma_hd192_group12_on_card(S, T, packed):
    """nemotron_4_340b's attention heads: hd 192, GQA group 12 over 8 kv
    heads (96/8), both pool modes, the decode plan that falls back to
    32-row blocks (int8 pools, T 4096) included: 0 quanta moved, the
    plain output, one launch on the pool mode's counter."""
    _need_card()
    from repro_torch.kernels.paged_attention import paged_plan

    args, kw = _mma_inputs(9000 + S + T, 192, 12, S, T, K=8, packed=packed)
    scale = torch.tensor(1.0 / 4096.0, device="cuda")
    assert horizon_stop(1.0 / 4096.0, 192)
    plan = paged_plan(4, 8, 12, S, 192, 16, T // 16, packed)
    _mma_launch(args, scale, 12, kw,
                f"hd=192 group=12 S={S} T={T} packed={packed} {plan}")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S", [1, 32])
def test_paged_attention_mma_group1_on_card(S, packed):
    """musicgen_medium's MHA: group 1 at hd 64 over 24 kv heads (a
    decode block fills 1 of its 16 rows), both pool modes."""
    _need_card()
    args, kw = _mma_inputs(9100 + S, 64, 1, S, 512, K=24, packed=packed)
    scale = torch.tensor(1.0 / 2048.0, device="cuda")
    _mma_launch(args, scale, 1, kw, f"hd=64 group=1 K=24 S={S} "
                f"packed={packed}")


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [96, 256])
def test_paged_attention_unsupported_head_dim_raises_on_card(hd):
    """No fallback: a head width the kernel is not compiled for raises
    on the card, and nothing is launched."""
    _need_card()
    args, _ = _mma_inputs(9200, hd, 2, 1, 512)
    n = paged_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(*args, torch.tensor(1.0 / 1024.0, device="cuda"),
                        group=2)
    assert paged_attention.launches == n


# (shape, form, rqt2 tables): GELU's LUT at musicgen's d_ff 6144,
# squared ReLU at nemotron's 73728, chunk (256 rows) and decode (8);
# shapes off 16-element vectors, per-channel and wrapping rqt2
ACT_CARD_CASES = [((256, 6144), "lut", None), ((8, 6144), "lut", None),
                  ((256, 73728), "square", "scalar"),
                  ((8, 73728), "square", "scalar"),
                  ((7, 333), "lut", None), ((7, 333), "square", "channel"),
                  ((256, 6144), "square", "channel"),
                  ((8, 6144), "square", "wrap"),
                  ((3, 5, 40), "square", "scalar")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,form,kind", ACT_CARD_CASES)
def test_requant_form_act_on_card(shape, form, kind):
    """The ungated MLP's activation (`requant_act`) against its plain
    version, exactly, one launch on the act form."""
    _need_card()
    from repro_torch.kernels import requant_act, requant_act_plain

    rng = np.random.default_rng(shape[0] + shape[-1] + len(form))
    s = torch.from_numpy(rng.integers(-128, 128, size=shape)
                         .astype(np.int8)).cuda()
    if form == "lut":
        t = {"lut": torch.from_numpy(rng.integers(-128, 128, size=256)
                                     .astype(np.int8)).cuda()}
    else:
        t = {"rqt2": _card_rqt(rng, shape[-1], kind, 1 / 255, zp=-128,
                               acc_bound=float(255 ** 2))}
    got = _counted("act", lambda: requant_act(s, t))
    assert got.dtype == torch.int8
    assert torch.equal(got, requant_act_plain(s, t))


# (K, N) of the new configs' GEMM sites: musicgen_medium's wq/wk/wv/wo,
# up, down and head; nemotron_4_340b's wq/wo and wk/wv and its down
# (K 73728; its up and head are held by chip_smoke.py, in column
# slices)
VARIANT_KN = [(1536, 1536), (1536, 6144), (6144, 1536), (1536, 2048),
              (18432, 18432), (18432, 1536), (73728, 18432)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("K,N", VARIANT_KN)
def test_int8_matmul_dense_variant_sites_on_card(K, N, M):
    _need_card()
    rng = np.random.default_rng(K + N + M)
    x, w, b = _gemm_operands(rng, M, K, N)
    for r in _gemm_tables(rng, K, N):
        got = int8_matmul(x, w, b, r)
        want = int8_matmul_plain(x, w, b, r)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (gemm_plan(M, N, K), r is None)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ["musicgen_medium", "nemotron_4_340b"])
def test_engine_dense_variants_on_card(arch, kv_bits):
    """A 2-layer reduced musicgen_medium (LayerNorm, GELU) or
    nemotron_4_340b (LayerNorm, squared ReLU) deployed on the card:
    the card's tokens equal the CPU's on one table set, and each layer
    and step launches the requant kernel once heads-to-rows, once on
    the act form and twice for the QAdds, and the GEMM 6 times."""
    _need_card()
    from repro_torch import kernels
    from repro_torch.launch.serve import ragged_requests

    gpu, cpu = _engines_on_card_and_cpu(arch, kv_bits)
    reqs = ragged_requests(5, gpu.lm.cfg.vocab, np.random.default_rng(3),
                           prompt_lo=5, prompt_hi=40, gen=5)
    kernels.reset_launch_counts()
    tok = _serve_all(gpu, reqs)
    L = gpu.lm.cfg.n_layers * gpu.stats()["steps"]
    assert requant.by_form == {"rqt_heads": L, "act": L, "add": 2 * L}
    assert int8_matmul.launches == 6 * L + gpu.stats()["steps"]
    assert (paged_attention_kv4 if kv_bits == 4 else
            paged_attention).launches == L
    assert tok == _serve_all(cpu, reqs)


# -- the grouped int8 GEMM (the MoE's expert GEMMs) and the slot pools --------
# (G, E, C, K, N): olmoe_1b_7b's gate/up and down sites at decode (C 4,
# the GEMV), prefill of a 254-token prompt (C 40) and of 512 (C 80, the
# wgmma path), then ragged shapes and one whose K splits over blocks
GROUPED_CASES = (
    [(1, 64, C, K, N) for C in (4, 40, 80)
     for K, N in ((2048, 1024), (1024, 2048))]
    + [(2, 3, 5, 48, 40), (1, 4, 17, 96, 136), (3, 2, 1, 160, 66),
       (1, 1, 2, 16384, 32), (1, 2, 70, 8192, 64)])


def _grouped_tables(rng, E, K, N):
    """int32 out, and int8 out through scalar, per-column and
    per-(expert, column) tables."""
    bound = float(K * 127 * 127)
    return [None,
            _rq(make_rqt(float(rng.uniform(1e-5, 4e-5)), 0.05,
                         acc_bound=bound)),
            _rq(make_rqt(rng.uniform(1e-5, 4e-5, size=N), 0.05,
                         acc_bound=bound)),
            _rq(make_rqt(rng.uniform(1e-5, 4e-5, size=(E, N)), 0.05,
                         acc_bound=bound))]


@pytest.mark.gpu
@pytest.mark.parametrize("G,E,C,K,N", GROUPED_CASES)
def test_int8_matmul_grouped_on_card(G, E, C, K, N):
    """Every group's x[g, e] @ w[e] exactly as the plain version, with
    every table form, in one launch a call, on the path and split
    `gemm_plan(C, N, K, G * E)` takes."""
    _need_card()
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )

    rng = np.random.default_rng(G * 1000 + E * 100 + C)
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    x = torch.randint(-128, 128, (G, E, C, K), dtype=torch.int8,
                      device="cuda", generator=g)
    w = torch.randint(-128, 128, (E, N, K), dtype=torch.int8, device="cuda",
                      generator=g).transpose(1, 2)
    for rqt in _grouped_tables(rng, E, K, N):
        n = int8_matmul_grouped.launches
        got = int8_matmul_grouped(x, w, rqt)
        assert int8_matmul_grouped.launches == n + 1
        want = int8_matmul_grouped_plain(x, w, rqt)
        assert got.dtype == want.dtype and torch.equal(got, want), (
            G, E, C, K, N, rqt is None)


@pytest.mark.gpu
def test_int8_matmul_grouped_refuses_a_dense_weight_layout():
    _need_card()
    from repro_torch.kernels import int8_matmul_grouped

    x = torch.zeros((1, 2, 4, 64), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="stored transposed"):
        int8_matmul_grouped(x, torch.zeros((2, 64, 32), dtype=torch.int8,
                                           device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,pos0", [(8, 1, 300), (1, 254, 0), (1, 512, 0),
                                      (2, 31, 0)])
def test_paged_attention_over_slot_pools_on_card(B, S, pos0):
    """The slot arena's storage through the paged kernel: pages of
    max_len 512 keys, one page a slot (pps 1), olmoe_1b_7b's heads (16 kv
    heads, group 1, hd 128): the decode at 8 slots (one parked) and
    whole-prompt prefills at B=1 up to 512 rows; 0 quanta moved."""
    _need_card()
    rng = np.random.default_rng(B * 1000 + S)
    K, group, hd, ps = 16, 1, 128, 512
    q = torch.from_numpy(rng.integers(-40, 41, size=(B, K * group, S, hd))
                         .astype(np.int8)).cuda()
    kp = torch.from_numpy(rng.integers(-40, 41, size=(B + 1, K, ps, hd))
                          .astype(np.int8)).cuda()
    vp = torch.from_numpy(rng.integers(-128, 128, size=(B + 1, K, ps, hd))
                          .astype(np.int8)).cuda()
    table = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")[:, None]
    pos = torch.full((B,), pos0, dtype=torch.int32, device="cuda")
    if B > 1 and S == 1:
        pos[-1] = INACTIVE_POS
    scale = torch.tensor(1.0 / 512.0, device="cuda")
    qp = torch.empty((B, K * group, S, ps), dtype=torch.int8, device="cuda")
    got = paged_attention(q, kp, vp, table, pos, scale, group=group,
                          qp_out=qp)
    assert check_kernel(got, qp, q, kp, vp, table, pos, scale, group=group,
                        what=f"slot pools B={B} S={S}") == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_moe_engine_card_equals_cpu(paged):
    """A reduced olmoe_1b_7b (calibrated and deployed on the card) served
    in exact mode over the slot arena and over the paged one: the card's
    tokens, and the slot pools after the drain, equal the CPU's; every
    expert GEMM of the card run is one grouped launch."""
    _need_card()
    import copy

    from repro_torch import kernels
    from repro_torch.launch.serve import deploy_model, ragged_requests
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    lm, t_gpu = deploy_model("olmoe_1b_7b", reduced=True, max_seq=128,
                             seed=0, device="cuda")
    tables = {"cuda": t_gpu, "cpu": tables_to(t_gpu, "cpu")}
    reqs = ragged_requests(5, lm.cfg.vocab, np.random.default_rng(3),
                           prompt_lo=3, prompt_hi=60, gen=5)
    out = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(lm, tables[device], ServingConfig(
            n_slots=3, max_len=128, paged=paged, page_size=8, device=device,
            scheduler=SchedulerConfig(prefill_chunk=8)))
        kernels.reset_launch_counts()
        for r in reqs:
            eng.submit(copy.deepcopy(r))
        done = eng.run_until_drained()
        counts = kernels.launch_counts()
        out[device] = ({c.req_id: c.tokens for c in done},
                       eng.arena.caches["k"].cpu(), counts)
    assert out["cuda"][0] == out["cpu"][0]
    if not paged:
        assert torch.equal(out["cuda"][1][:, 1:], out["cpu"][1][:, 1:])
    counts = out["cuda"][2]
    assert counts["int8_matmul_grouped"] > 0
    assert counts["int8_matmul_grouped"] % (3 * lm.cfg.n_layers) == 0


# the NemoCNN's GEMMs at full width (channels 16/32/64, 32 x 32 images):
# (M, K, N) of conv1 (K 27 padded to 32), conv2, conv3 at B 2 and 64,
# the head at B 8 (the GEMV) and 256
CNN_GEMM_CASES = [(B * hw, K, N) for B in (2, 64)
                  for hw, K, N in ((1024, 32, 16), (256, 144, 32),
                                   (64, 288, 64))] + [
    (8, 1024, 10), (256, 1024, 10), (17, 32, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", CNN_GEMM_CASES)
def test_int8_matmul_cnn_shapes_on_card(M, K, N):
    """Both paths at the CNN's shapes (N 10, 16, 32, 64 below every
    serving N), int32 out and int8 out through scalar and per-column
    tables, exactly as the plain version."""
    _need_card()
    rng = np.random.default_rng(M * 7 + K + N)
    x, w, b = _gemm_operands(rng, M, K, N)
    for r in _gemm_tables(rng, K, N):
        got = int8_matmul(x, w, b, r)
        want = int8_matmul_plain(x, w, b, r)
        assert got.dtype == want.dtype and torch.equal(got, want), (
            gemm_plan(M, N, K), r is None)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 32, 32, 16), (64, 16, 16, 32),
                                   (64, 8, 8, 64), (3, 5, 7, 16)])
def test_requant_cnn_per_channel_on_card(shape):
    """The integer BN's requant (apply_rqt per channel, the NemoCNN's
    intbn mode) at N 16, 32 and 64: one launch, the plain version's
    bytes."""
    _need_card()
    rng = np.random.default_rng(shape[-1] + shape[0])
    q = torch.from_numpy(rng.integers(-(1 << 28), 1 << 28, size=shape)
                         .astype(np.int32)).cuda()
    rq = _rq(make_rqt(rng.uniform(1e-6, 4e-6, size=shape[-1]), 0.02,
                      zp_out=-128, acc_bound=2.0 ** 28))
    n = requant.launches
    got = requant(q, rq)
    assert requant.launches == n + 1
    assert torch.equal(got, requant_plain(q, rq))


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [16, 256])
def test_threshold_search_equals_count_on_card(levels):
    """The thresh mode's count by binary search equals the comparison
    count on the card and on the CPU, repeated thresholds, values on
    them and past both ends included."""
    _need_card()
    from repro_torch.core.bn import (
        apply_thresholds, threshold_count, thresholds_to_torch,
    )

    rng = np.random.default_rng(levels)
    C = 16
    th = np.sort(rng.integers(-5000, 5000, size=(C, levels - 1)), axis=1)
    th[0] = 3
    th[1, 2:9] = th[1, 2]
    q = rng.integers(-6000, 6000, size=(8, 32, 32, C)).astype(np.int32)
    q[0, 0, 0] = th[:, 0]
    q[0, 0, 1] = th[:, -1]
    tt = thresholds_to_torch(th, "cuda")
    qc = torch.from_numpy(q).cuda()
    want = threshold_count(torch.from_numpy(q), tt.cpu())
    for got in (apply_thresholds(qc, tt), threshold_count(qc, tt)):
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fold", "intbn", "thresh"])
def test_cnn_id_card_equals_cpu(mode):
    """The full-width NemoCNN calibrated on the card (ranges within 1e-4
    of the CPU's span), deployed once, its ID forward on 32 images: the
    card's logits and every block's and pool's int8 activations equal
    the CPU's; each conv and the head one GEMM launch, intbn's requant
    one launch a block."""
    _need_card()
    from repro_torch import kernels
    from repro_torch.models.cnn import (
        NemoCNN, image_inputs, perturb_bn_np, tables_from_numpy,
    )

    rng = np.random.default_rng(26)
    cnn = NemoCNN()
    p = perturb_bn_np(cnn.init_np(0), rng)
    img = rng.integers(0, 256, size=(32, 32, 32, 3), dtype=np.uint8)
    x, s_x = image_inputs(img, "cuda")
    calib = cnn.calibrate(p, x, device="cuda")
    ref = cnn.calibrate(p, x.cpu(), device="cpu")
    for n in ref.hi:
        span = ref.hi[n] - ref.lo[n]
        assert abs(calib.hi[n] - ref.hi[n]) <= 1e-4 * span, n
        assert abs(calib.lo[n] - ref.lo[n]) <= 1e-4 * span, n
    t_np = cnn.deploy(p, calib, bn_mode=mode)
    want_trace, got_trace = [], []
    want = cnn.apply_id(tables_from_numpy(t_np, "cpu"), s_x.cpu(),
                        want_trace)
    kernels.reset_launch_counts()
    got = cnn.apply_id(tables_from_numpy(t_np, "cuda"), s_x, got_trace)
    counts = kernels.launch_counts()
    assert torch.equal(got.cpu(), want)
    for a, b in zip(got_trace, want_trace):
        assert torch.equal(a.cpu(), b)
    assert counts["int8_matmul"] == len(cnn.channels) + 1
    assert counts["requant"] == (len(cnn.channels) if mode == "intbn" else 0)


# -- the integer softmax and the write-then-gather attention --------------
# (groups, S, group, hd, T): granite_3_2b's attention at the main cell
# (8 slots x 8 kv heads, group 4, hd 64, T 512) for a chunk and a decode
# row, and a T that P.V pads to a multiple of 16
GATHER_CASES = [(64, 32, 4, 64, 512), (64, 1, 4, 64, 512),
                (6, 5, 2, 32, 40), (16, 1, 12, 192, 520)]


@pytest.mark.gpu
@pytest.mark.parametrize("E,S,group,hd,T", GATHER_CASES)
def test_int8_matmul_grouped_attention_products_on_card(E, S, group, hd, T):
    """The gather path's two products on the grouped GEMM, int32 out,
    exactly as the plain version, one launch each, counted under their
    (groups, C, K, N, "int32") keys: scores (q's group * S rows of each
    slot and kv head against its T keys) and P.V (the image, T padded
    to 16 with zero columns, against V stored (hd, T))."""
    _need_card()
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )

    C, Tp = group * S, -(-T // 16) * 16
    g = torch.Generator(device="cuda").manual_seed(E * 1000 + T + S)
    q = torch.randint(-128, 128, (1, E, C, hd), dtype=torch.int8,
                      device="cuda", generator=g)
    k = torch.randint(-128, 128, (E, T, hd), dtype=torch.int8,
                      device="cuda", generator=g)
    p = torch.randint(0, 128, (1, E, C, Tp), dtype=torch.int8,
                      device="cuda", generator=g)
    p[..., T:] = 0
    vt = torch.randint(-128, 128, (E, hd, Tp), dtype=torch.int8,
                       device="cuda", generator=g)
    int8_matmul_grouped.by_shape = {}
    for x, w, key in ((q, k.transpose(1, 2), (E, C, hd, T, "int32")),
                      (p, vt.transpose(1, 2), (E, C, Tp, hd, "int32"))):
        n = int8_matmul_grouped.launches
        got = int8_matmul_grouped(x, w)
        assert int8_matmul_grouped.launches == n + 1
        assert int8_matmul_grouped.by_shape[key] == 1
        want = int8_matmul_grouped_plain(x, w)
        assert got.dtype == torch.int32 and torch.equal(got, want), key


# the CPU test's overflow cells (tests/test_torch_int_softmax.py): eps_s,
# score amplitude, masked share, T
INT_SOFTMAX_CASES = [(1e-6, 2 ** 22, 0.0, 64), (1e-5, 10 ** 4, 0.3, 37),
                     (1e-4, 2 ** 22, 0.3, 37), (1e-3, 100, 0.5, 16),
                     (1e-2, 10 ** 4, 0.3, 130), (3e-3, 2 ** 22, 0.0, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("eps_s,amp,masked,T", INT_SOFTMAX_CASES)
def test_int_softmax_card_equals_cpu(eps_s, amp, masked, T):
    """`int_softmax` on the card gives the CPU's image byte for byte on
    inputs whose int32 products wrap and shift by negative amounts (a
    fully masked row among them), and reads its tables without a host
    sync (torch's sync debug mode at "error")."""
    _need_card()
    from repro_torch.core.intsoftmax import (
        int_softmax, make_int_softmax_tables,
    )

    rng = np.random.default_rng(int(eps_s * 1e7) + T)
    tabs = {k: torch.from_numpy(np.array(v))
            for k, v in make_int_softmax_tables(eps_s).items()}
    s = torch.from_numpy(rng.integers(-amp, amp, size=(2, 4, 5, T)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((2, 1, 5, T)) >= masked)
    mask[1, 0, 2, :] = False
    want = int_softmax(s, tabs, mask=mask)
    card = {k: v.cuda() for k, v in tabs.items()}
    sc, mc = s.cuda(), mask.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = int_softmax(sc, card, mask=mc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.dtype == torch.int8 and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_engine_int_softmax_card_equals_cpu(kv_bits):
    """A 2-layer granite engine under `attn_softmax="int"`: the card's
    tokens equal the CPU's, the attention on the grouped GEMM (two
    launches a layer and dispatch) and never on the paged kernel; and
    under the float island `paged_kernel=False` gives the default
    engine's tokens on the card."""
    _need_card()
    from repro_torch import kernels
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.launch.variants import use_variants

    card, cpu = _engines_on_card_and_cpu("granite_3_2b", kv_bits)
    reqs = ragged_requests(5, card.lm.cfg.vocab, np.random.default_rng(8),
                           prompt_lo=5, prompt_hi=40, gen=6)
    kernels.reset_launch_counts()
    with use_variants(attn_softmax="int"):
        tok = _serve_all(card, reqs)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert tok == _serve_all(cpu, reqs)
    assert counts["paged_attention"] == counts["paged_attention_kv4"] == 0
    n = counts["int8_matmul_grouped"]
    assert n > 0 and n % (2 * card.lm.cfg.n_layers) == 0
    default, _ = _engines_on_card_and_cpu("granite_3_2b", kv_bits)
    gather, _ = _engines_on_card_and_cpu("granite_3_2b", kv_bits,
                                         paged_kernel=False)
    assert _serve_all(gather, reqs) == _serve_all(default, reqs)


# -- the ssm family: the scan island and the Mamba-1 layer ------------------
def _island_sweep():
    """float32 inputs over the island functions' domains: exp's [-110,
    0], log's and log1p's (0, 4] and (0, 1], softplus's [-100, 100]."""
    rng = np.random.default_rng(21)
    return {
        "exp": -rng.uniform(0, 110, 1 << 20),
        "log": np.exp(rng.uniform(-80, 1.4, 1 << 20)),
        "log1p": np.concatenate([rng.uniform(0, 1, 1 << 19),
                                 np.exp(-rng.uniform(0, 80, 1 << 19))]),
        "softplus": rng.uniform(-100, 100, 1 << 20),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["exp", "log", "log1p", "softplus"])
def test_ssm_island_function_card_equals_cpu(fn):
    """Each fixed float32 sequence of `core.island` gives the CPU's bits
    on the card over a sweep of its domain."""
    _need_card()
    from repro_torch.core import island

    f = {"exp": island.exp_f32, "log": island.log_f32,
         "log1p": island.log1p_f32, "softplus": island.softplus_f32}[fn]
    x = torch.from_numpy(_island_sweep()[fn].astype(np.float32))
    got = f(x.cuda()).cpu()
    assert torch.equal(got.view(torch.int32), f(x).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("L,h0", [(1, True), (5, False), (127, True),
                                  (128, False), (200, True), (256, True)])
def test_ssm_core_card_equals_cpu(L, h0):
    """The scan core (softplus'd dt, exp(dt A), the associative scan and
    its chunks, the 16-lane sum) on the card gives the CPU's y and h bit
    for bit, subnormal-flushed states included."""
    _need_card()
    from repro_torch.core.island import softplus_f32
    from repro_torch.layers.ssm import ssm_core

    g = torch.Generator().manual_seed(L)
    B, di, ds = 2, 64, 16
    x1 = torch.randint(-128, 128, (B, L, di), generator=g) * 0.02
    x1 = x1 * (torch.rand(B, L, di, generator=g) < 0.5)
    dt = softplus_f32(torch.randn(B, L, di, generator=g) * 3)
    bm = torch.randint(-128, 128, (B, L, ds), generator=g) * 0.03
    cm = torch.randint(-128, 128, (B, L, ds), generator=g) * 0.03
    A = -torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds)
    D = torch.ones(di)
    hs = torch.randn(B, di, ds, generator=g) if h0 else None
    args = [x1.float(), dt, bm.float(), cm.float(), A.contiguous(), D]
    y, h = ssm_core(*args, h0=hs)
    yc, hc = ssm_core(*[a.cuda() for a in args],
                      h0=None if hs is None else hs.cuda())
    assert torch.equal(yc.cpu().view(torch.int32), y.view(torch.int32))
    assert torch.equal(hc.cpu().view(torch.int32), h.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_ssm_engine_card_equals_cpu(paged):
    """A reduced falcon_mamba_7b (calibrated and deployed on the card;
    dt_proj's K 8 padded to 16 on the GEMM) served in exact mode over
    either arena: the card's tokens and its arena's conv and h state
    after the drain equal the CPU's bit for bit; per layer and dispatch
    four GEMM launches and the requant kernel's rqt, act, gate and add
    once each."""
    _need_card()
    from repro_torch import kernels
    from repro_torch.launch.serve import deploy_model, ragged_requests
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    lm, t_gpu = deploy_model("falcon_mamba_7b", reduced=True, max_seq=256,
                             seed=0, device="cuda")
    tables = {"cuda": t_gpu, "cpu": tables_to(t_gpu, "cpu")}
    reqs = ragged_requests(5, lm.cfg.vocab, np.random.default_rng(5),
                           prompt_lo=3, prompt_hi=200, gen=5)
    out = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(lm, tables[device], ServingConfig(
            n_slots=3, max_len=256, paged=paged, page_size=8, device=device,
            scheduler=SchedulerConfig()))
        kernels.reset_launch_counts()
        tok = _serve_all(eng, reqs)
        out[device] = (tok, eng.arena.caches["conv"].cpu(),
                       eng.arena.caches["h"].cpu().view(torch.int32),
                       kernels.launch_counts(), dict(kernels.requant.by_form))
    assert out["cuda"][0] == out["cpu"][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    counts, forms = out["cuda"][3:]
    n = forms["add"]
    assert n > 0 and n % lm.cfg.n_layers == 0
    assert forms == {"rqt": n, "act": n, "gate": n, "add": n}
    assert counts["int8_matmul"] == (4 + 1 / lm.cfg.n_layers) * n
    assert counts["paged_attention"] == counts["int8_matmul_grouped"] == 0


@pytest.mark.gpu
def test_pact_ste_card_equals_cpu():
    """The three STE functions on the card: the forward images and the
    masked gradients dx / dw bit for bit with the CPU's; the clips'
    gradients, float32 sums in each device's order rounded to the
    gradient's dtype, within 1e-6 of the sum of the terms' magnitudes
    plus one ulp of that dtype."""
    _need_card()
    from repro_torch.core import pact

    rng = np.random.default_rng(30)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.uniform(-3, 5, size=(64, 257)).astype(
            np.float32)).to(dtype)
        g = torch.from_numpy(rng.standard_normal(x.shape).astype(
            np.float32)).to(dtype)
        out = {}
        for dev in ("cuda", "cpu"):
            xt = x.to(dev).requires_grad_()
            a = torch.tensor(-1.0, device=dev, requires_grad=True)
            b = torch.tensor(3.0, device=dev, requires_grad=True)
            y = pact.pact_act_asymm(xt, a, b, 8)
            out[dev] = [t.cpu() for t in (y,) + torch.autograd.grad(
                y, (xt, a, b), g.to(dev))]
        for i, what in ((0, "forward"), (1, "dx")):
            assert torch.equal(out["cuda"][i], out["cpu"][i]), (dtype, what)
        scale = float(g.float().abs().sum())
        ulp = torch.finfo(dtype).eps
        for i, what in ((2, "dalpha"), (3, "dbeta")):
            c, h = float(out["cuda"][i]), float(out["cpu"][i])
            assert abs(c - h) <= 1e-6 * scale + ulp * abs(h), (dtype, what,
                                                               c, h)
    w = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    gw = torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))
    got = {}
    for dev in ("cuda", "cpu"):
        wt = w.to(dev).requires_grad_()
        beta = pact.default_weight_beta(wt) * 0.75
        y = pact.pact_weight(wt, beta, 8, -1)
        got[dev] = (y.detach().cpu(),
                    torch.autograd.grad(y, wt, gw.to(dev))[0].cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0]), "w_hat"
    assert torch.equal(got["cuda"][1], got["cpu"][1]), "dw"


@pytest.mark.gpu
def test_fq_train_step_card_close_to_cpu():
    """Reduced granite_3_2b: the FQ loss within 1e-3 relative of the
    CPU's and every gradient leaf within 2e-2 relative L2 (bf16 products
    in other orders), then `launch.train.build`'s step on the card:
    three steps whose losses track the CPU's within 2e-2."""
    _need_card()
    from repro_torch.core.rep import Rep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import build

    res = {}
    for dev in ("cuda", "cpu"):
        lm, tr, opt, step, stream = build("granite_3_2b", reduced=True,
                                          seq=32, batch=4, device=dev)
        tok = torch.from_numpy(stream.batch(0)).to(dev)
        loss, g = value_and_grad(lambda t, x: lm.loss_fn(
            t["params"], t["qstate"], x, Rep.FQ), tr, tok)
        losses = []
        for s in range(3):
            li, tr, opt = step(tr, opt, torch.from_numpy(
                stream.batch(s)).to(dev))
            losses.append(float(li))
        res[dev] = (float(loss), [x.cpu() for x in tree_leaves(g)], losses)
    (lc, gc, sc), (lh, gh, sh) = res["cuda"], res["cpu"]
    assert abs(lc - lh) <= 1e-3 * abs(lh)
    for a, b in zip(gc, gh):
        den = float(b.norm())
        assert (float((a - b).norm()) / den if den else float(a.norm())
                ) <= 2e-2
    assert all(abs(a - b) <= 2e-2 * abs(b) for a, b in zip(sc, sh))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("S", [1, 32])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_attention_per_head_range_equals_whole_launch(packed, S, n):
    """The paged attention per kv-head range (the kv-sharded serving
    path): at granite's geometry (H 32, K 8, hd 64, pages of 16, T
    512), each of n ranks' launches over its own operands (its K / n kv
    heads' pools and (6, K / n) unpack columns, its H / n query heads),
    concatenated along the heads, equals the whole-pool launch exactly;
    one launch a rank on the pool mode's counter."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + n)
    B, H, K, hd, ps, T = 8, 32, 8, 64, 16, 512
    hs = hd // 2 if packed else hd
    n_pool = B * (T // ps) + 1
    q = torch.randint(-40, 41, (B, H, S, hd), dtype=torch.int8,
                      device="cuda", generator=g)
    kp, vp = (torch.randint(-128, 128, (n_pool, K, ps, hs), dtype=torch.int8,
                            device="cuda", generator=g) for _ in range(2))
    table = torch.randperm(n_pool - 1, device="cuda", generator=g)[
        :B * (T // ps)].add(1).to(torch.int32).reshape(B, T // ps)
    pos = torch.randint(0, T - S, (B,), dtype=torch.int32, device="cuda",
                        generator=g)
    pos[-1] = INACTIVE_POS
    scale = torch.tensor(1.0 / 2048.0, device="cuda")
    kw = dict(group=H // K)
    if packed:
        kw["k_rq"] = staged_unpack_rq(K).cuda()
        kw["v_rq"] = torch.roll(kw["k_rq"], 3, dims=1)
    whole = paged_attention(q, kp, vp, table, pos, scale, **kw)
    counter = paged_attention_kv4 if packed else paged_attention
    c0 = counter.launches
    kl, hl = K // n, H // n

    def rank(r):
        kr = slice(r * kl, (r + 1) * kl)
        kw_r = dict(kw)
        if packed:
            kw_r.update(k_rq=kw["k_rq"][:, kr].contiguous(),
                        v_rq=kw["v_rq"][:, kr].contiguous())
        return paged_attention(
            q[:, r * hl:(r + 1) * hl].contiguous(), kp[:, kr].contiguous(),
            vp[:, kr].contiguous(), table, pos, scale, **kw_r)

    parts = [rank(r) for r in range(n)]
    assert counter.launches == c0 + n
    assert all(p.shape == (B, H // n, S, hd) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1_2b"])
def test_bf16_island_engine_card_equals_cpu(arch):
    """Under ``ssm_island_dtype="bf16"``: a reduced model (calibrated
    and deployed on the card) serves a 256-token prompt (two bf16 scan
    chunks) and a 37-token one at their exact length over `SlotArena`;
    the card's tokens and the arena's conv and h state equal the CPU's
    bit for bit, and the h state differs from the float32 island's."""
    _need_card()
    from repro_torch.launch.serve import deploy_model, serve_scenario

    lm, t_gpu = deploy_model(arch, reduced=True, max_seq=320, seed=0,
                             device="cuda")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, lm.cfg.vocab, size=(n,)).tolist(), 4)
            for n in (256, 37)]
    out = {}
    for dev, t in (("cuda", t_gpu), ("cpu", tables_to(t_gpu, "cpu"))):
        for dtype in ("bf16", "f32"):
            out[dev, dtype] = serve_scenario(lm, t, dict(
                config=dict(n_slots=2, max_len=320), requests=reqs,
                variants=dict(ssm_island_dtype=dtype)), device=dev)
    card, cpu = out["cuda", "bf16"], out["cpu", "bf16"]
    assert card["tokens"] == cpu["tokens"]
    assert torch.equal(card["pools"]["conv"], cpu["pools"]["conv"])
    assert torch.equal(card["pools"]["h"].view(torch.int32),
                       cpu["pools"]["h"].view(torch.int32))
    assert not torch.equal(cpu["pools"]["h"], out["cpu", "f32"]["pools"]["h"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_1_2b"])
def test_float_cache_decode_equals_no_cache_forward_on_card(arch):
    """The float forward through `init_caches(rep=FP)` on the card: a
    24-token prefill and 4 decodes of a reduced model; each step's
    logits within 5e-2 of their span of the no-cache forward over the
    whole sequence so far (the cache holds K / V in bfloat16), and
    within 1e-3 of the CPU's."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.core.rep import Rep
    from repro_torch.models.lm import DecoderLM

    P, D = 24, 4
    lm = DecoderLM(get_config(arch).reduced(), max_seq=P + D)
    p = lm.init_np(0)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, lm.cfg.vocab, size=(2, P + D)).astype(np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        pt, tk = params_to_torch(p, dev), tok.to(dev)
        with torch.no_grad():
            caches = lm.init_caches(2, P + D, Rep.FP, device=dev)
            x, caches = lm.apply(pt, lm.embed_in(pt, tk[:, :P]),
                                 caches=caches, pos=0)
            steps = [lm.logits(pt, x)[:, -1]]
            for d in range(D):
                x, caches = lm.apply(pt, lm.embed_in(pt, tk[:, P + d:P + d + 1]),
                                     caches=caches, pos=P + d)
                steps.append(lm.logits(pt, x)[:, -1])
            for d, got in enumerate(steps):
                full = lm.logits(pt, lm.apply(pt, lm.embed_in(
                    pt, tk[:, :P + d])))[:, -1]
                span = float(full.max() - full.min())
                assert float((got - full).abs().max()) <= 5e-2 * span, d
        out[dev] = [s.cpu() for s in steps]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.max() - b.min())
