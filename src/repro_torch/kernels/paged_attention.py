"""Unified (S, T) int8 paged attention (port of
`repro.kernels.paged_attention`, int8 pool mode; CUDA source
csrc/paged_attention.cu).

Contract (the reference's `paged_attention_pallas`): q (B, H, S, hd)
int8, query row s of slot b at logical position pos[b] + s; K/V pools
(n_pages + 1, K, ps, hd) int8 with page 0 the PAGE_NULL trash page;
table (B, pps) int32 physical page ids; pos (B,) int32; score_scale a
0-d float32 tensor; GQA by kv head h // group.  Returns the (B, H, S,
hd) int32 P.V accumulator (the caller applies ctx_rqt).

`paged_attention_plain` is the torch port of
`repro.kernels.ref.paged_attention_ref`: gather the logical (B, K, T,
hd) view through the table, integer scores, -1e9 additive causal mask,
one global f32 softmax per row, round(127 p) to the int8 image, integer
P.V.  The integer products run in float64, exact at these ranges
(|terms| <= 2^14, T*hd far below 2^39).  The row sum of the softmax is
taken in the kernel's order (`_lane_sum`), and its exponent is
`island_exp`, a fixed sequence of float32 operations each rounded once,
which the kernel repeats step for step; so the plain image equals the
kernel's bit for bit, and the plain version gives the same image on
the CPU as on the card (a library exp differs between the two on a few
percent of inputs).  The reference leaves that order and its exp to
XLA.

Int4-packed pool mode (the reference's `packed` kernel mode, kv_bits
4): pools (n_pages + 1, K, ps, hd/2) int8, two int4 nibbles per cell
(element 2i in the low nibble), with `k_rq`/`v_rq` (6, K) int32 unpack
operands (rows m, s0, lo, hi, d, zp per kv head).  Every page load is
unpacked back into the int8 image space by the requant formula
(`kv4_unpack`): clip to [lo, hi], >> s0, * m, >> (d - s0), + zp, clip
to [-128, 127]; everything after that is the int8 mode.  Its launches
count apart, on `paged_attention_kv4.launches`.

On the card both pool modes run one tensor-core kernel, with the launch
`paged_plan` picks from the shape alone: one block per slot, kv head
and 16 or 32 stacked group rows, warps splitting each staged tile of
keys, three passes over the keys with the logits kept in shared memory
where they fit and the scores recomputed where not, each row stopped
at its causal horizon while `horizon_stop` holds.  Over packed pools
the staged tiles hold the packed rows, and each block expands them
through two 16-entry tables of its kv head (the function of
`kv4_unpack` evaluated once for each of the 16 nibble values).

`check_image` is the stated tolerance of the kernel's probability
image (``qp_out``) against the plain one, `check_kernel` that of the
kernel's whole result; `staged_unpack_rq` gives per-head operands that
make a wrong unpack show in those checks.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.intmath import unpack_int4
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import SMS

NEG_INF = -1e9
_SMEM_LIMIT = 220 * 1024  # of the 227 KB a block may opt into
_LANES = 32  # the row sum's partials (`_lane_sum`)
# the horizon stop is exact while |score_scale| * 128 * 128 * hd stays at
# or below this (kStopGuard in the CUDA source, which derives it)
STOP_GUARD = 4.9e8
# check_image: share of the image's entries that may move by one quantum
MOVED_SHARE = 1e-5


# island_exp's float32 constants, exact (hex; the CUDA source spells
# the same hex literals): Cephes' expf, log2(e), ln 2 split in two (C1
# has 9 significant bits, so k * C1 is exact for |k| < 2^15), and the
# polynomial P with e^r ~ 1 + r + r^2 P(r) on |r| <= ln(2) / 2,
# highest power first
_LOG2E = float.fromhex("0x1.715476p+0")
_LN2_C1, _LN2_C2 = float.fromhex("0x1.63p-1"), float.fromhex("-0x1.bd0106p-13")
_EXP_POLY = tuple(float.fromhex(h) for h in (
    "0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7", "0x1.555382p-5",
    "0x1.555554p-3", "0x1p-1"))
# below this island_exp gives 0.0 (the horizon stop's premise)
EXP_ZERO_BELOW = -104.0


def island_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor x <= 0 as the kernel's `island_exp`
    computes it: k = rint(x log2 e), r = x - k C1 - k C2, e^r by a
    degree-7 polynomial in Horner form, times 2^k in two exact-power
    steps (one rounding, subnormals included), 0 below -104.  Every
    step is one IEEE float32 operation rounded to nearest, so the result
    is the same on every device; within 1 ulp of the exact value."""
    f32 = torch.float32
    x = x.to(f32)

    def c(v):
        return torch.tensor(v, dtype=f32, device=x.device)

    k = torch.round(x * c(_LOG2E))
    r = (x - k * c(_LN2_C1)) - k * c(_LN2_C2)
    p = c(_EXP_POLY[0])
    for coef in _EXP_POLY[1:]:
        p = p * r + c(coef)
    y = (p * (r * r) + r) + c(1.0)
    ki = k.to(torch.int32)
    k1 = torch.div(ki, 2, rounding_mode="floor")
    y = (y * ((k1 + 127) << 23).view(f32)) * ((ki - k1 + 127) << 23).view(f32)
    return torch.where(x < EXP_ZERO_BELOW, torch.zeros_like(y), y)


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis in the kernel's float order: lane l of 32
    adds t = l, l + 32, ... in turn from 0, then a xor butterfly over
    the 32 partials (every lane ends with the same value)."""
    T = p.shape[-1]
    p = torch.nn.functional.pad(p, (0, (-T) % _LANES))
    cols = p.reshape(*p.shape[:-1], -1, _LANES)
    part = torch.zeros_like(cols[..., 0, :])
    for j in range(cols.shape[-2]):
        part = part + cols[..., j, :]
    lane = torch.arange(_LANES, device=p.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ o]
    return part[..., :1]


def horizon_stop(score_scale: float, hd: int) -> bool:
    """Whether the kernel stops each row at its causal horizon: the
    host mirror of the kernel's guard, which it reads on the device
    from *score_scale (a float32 product and compare, as here)."""
    a = np.float32(abs(np.float32(score_scale))) * np.float32(16384.0 * hd)
    return bool(a <= np.float32(STOP_GUARD))


class PagedPlan(NamedTuple):
    """How the wrapper launches the kernel for one shape."""
    kernel: str   # "mma": the tensor-core kernel (both pool modes)
    rows: int     # query rows of a block: 16 or 32 stacked group rows
    warps: int    # warps of a block, each taking one 32-key chunk of a
                  # staged tile for one 16-row tile
    keys: int     # keys of a staged tile
    stages: int   # cp.async ring slots
    blocks: int
    smem: int     # dynamic shared bytes of a block
    logits: str   # "shared" (pass 0 keeps the f32 logits in shared
                  # memory for passes 1 and 2) or "recomputed" (the
                  # scores taken again on the tensor cores in each of
                  # three passes)


# the head widths the mma kernel is compiled for (PA_MMA_CASE in the
# CUDA source); any other raises on the card
HEAD_DIMS = (32, 64, 128, 192)
# the (warps, rows) launch shapes the mma kernel is compiled for: 8 warps
# over the keys of one 16-row tile, or 4 over each of two
MMA_SHAPES = ((8, 16), (8, 32))
# the mma kernel keeps a block's rows of logits in shared memory while
# they take at most this many bytes (16 rows: T <= 1024; 32: T <= 512;
# decode at group 4, 4 rows: T <= 4096)
KEEP_LOGITS_BYTES = 80 * 1024


def _logit_bytes(warps: int, rows: int, M: int, T: int) -> int:
    """Bytes of the f32 logits the mma kernel keeps: the block's rows
    below M over every tile of T."""
    bt = 32 * warps * 16 // rows
    return 4 * min(rows, M) * (-(-T // bt) * bt + 8)


def _mma_smem(hd: int, warps: int, rows: int, stages: int, M: int, T: int,
              pps: int, keep: bool, packed: bool = False) -> int:
    """Shared bytes of the tensor-core kernel (its csrc layout): the
    ring (a K or V tile a slot with the logits kept, else both; rows of
    hd bytes, or hd/2 packed, 16 bytes apart more), the packed mode's
    two 16-byte unpack tables, V^T, the f32 rows (the logits, or one
    staging tile), the row maxima and sums, the page table; at least
    the P.V reduction, which reuses the space at the end."""
    bt = 32 * warps * 16 // rows
    f32_rows = (_logit_bytes(warps, rows, M, T) if keep
                else 4 * rows * (bt + 8))
    row = (hd // 2 if packed else hd) + 16
    layout = (stages * (1 if keep else 2) * bt * row + (32 if packed else 0)
              + hd * (bt + 16) + f32_rows + 64 * warps + 4 * rows
              + 16 * ((pps + 3) // 4))
    return max(layout, 64 * warps * (hd + 8))


def paged_plan(B: int, K: int, group: int, S: int, hd: int, ps: int,
               pps: int, packed: bool = False) -> PagedPlan:
    """The launch for one shape, either pool mode: a block of 8 warps
    per slot, kv head and 16 or 32 of the group * S stacked rows.
    Where 16-row blocks would leave SMs idle (decode), 16 rows, 8 warps
    over their keys (256 a staged tile) and the deepest ring of 4, 3 or
    2 tiles that fits; else, and where no such ring fits (hd 192 over
    int8 pools with the scores recomputed), 32 rows (two tiles, 4 warps
    over each, K/V staged once for both) and a ring of 2.  The logits
    stay in shared memory while they take at most KEEP_LOGITS_BYTES,
    else each pass recomputes the scores.  `packed` (int4-packed pools)
    only shrinks the ring's rows and adds the two unpack tables to the
    layout.  (`tools/attn_ab.py --sweep [--packed]` times every such
    plan.)"""
    T = pps * ps
    M = group * S
    shapes = [(8, 32, (2,))]
    if B * K * -(-M // 16) < SMS:
        shapes.insert(0, (8, 16, (4, 3, 2)))
    for warps, rows, depths in shapes:
        keep = _logit_bytes(warps, rows, M, T) <= KEEP_LOGITS_BYTES
        for stages in depths:
            smem = _mma_smem(hd, warps, rows, stages, M, T, pps, keep,
                             packed)
            if smem <= _SMEM_LIMIT:
                break
        if smem <= _SMEM_LIMIT:
            break
    return PagedPlan("mma", rows, warps, 32 * warps * 16 // rows, stages,
                     B * K * -(-M // rows), smem,
                     "shared" if keep else "recomputed")


def kv4_unpack(pool: torch.Tensor, rq: torch.Tensor) -> torch.Tensor:
    """An int4-packed pool (.., K, ps, hd/2) -> its int8 image (.., K,
    ps, hd) through the per-kv-head unpack operand rq (6, K): the
    plain version of the kernel's page-load unpack (the reference's
    `kv4_unpack_page_ref`, applied to every page at once)."""
    m, s0, lo, hi, d, zp = (r.to(torch.int32).reshape(-1, 1, 1)
                            for r in rq)
    x = unpack_int4(pool).to(torch.int32)
    x = torch.minimum(torch.maximum(x, lo), hi)
    staged = torch.bitwise_right_shift(x, s0) * m
    out = torch.bitwise_right_shift(staged, d - s0) + zp
    return out.clamp(-128, 127).to(torch.int8)


def gathered_view(pool, table, group: int):
    """The logical (B, H, T, hd) view of a pool through the table."""
    B, pps = table.shape
    _, K, ps, hd = pool.shape
    x = pool[table.to(torch.int64)]                      # (B, pps, K, ps, hd)
    x = x.permute(0, 2, 1, 3, 4).reshape(B, K, pps * ps, hd)
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def island_probs(scores, pos, score_scale):
    """The float island on int32 scores (B, H, S, T), query row s of
    slot b at position pos[b] + s: logits scores * score_scale, -1e9
    past each row's position, `island_exp` of the logits less the row
    max over `_lane_sum` -> float32 probabilities.  The kernel computes
    the same in the same order, so both paths give one image."""
    S, T = scores.shape[2], scores.shape[3]
    lg = scores.to(torch.float32) * score_scale.to(torch.float32)
    q_pos = pos.to(torch.int64)[:, None] + torch.arange(
        S, device=scores.device)
    k_pos = torch.arange(T, device=scores.device)
    keep = k_pos[None, None, :] <= q_pos[:, :, None]     # (B, S, T)
    lg = lg + torch.where(keep, 0.0, NEG_INF)[:, None]
    m = lg.amax(dim=-1, keepdim=True)
    p = island_exp(lg - m)
    return p / _lane_sum(p)


def attention_probs(q, k_pool, table, pos, score_scale, *, group: int = 1):
    """The float32 softmax (B, H, S, T) of the plain version, before the
    int8 image."""
    kh = gathered_view(k_pool, table, group)
    scores = torch.matmul(q.to(torch.float64),
                          kh.to(torch.float64).transpose(-1, -2))
    return island_probs(scores.to(torch.int32), pos, score_scale)


def check_image(qp: torch.Tensor, want_qp: torch.Tensor, what: str = "",
                unit: str = "probability") -> int:
    """Tolerance of a probability image against the plain version's:
    no entry may move by more than one quantum, and at most max(8,
    MOVED_SHARE of the entries) may move at all.  On the card the plain
    version rounds exactly like the kernel, so a sound kernel moves
    none; a kernel that rounds down or uses a coarser exp or division
    moves many entries by one.  Raises AssertionError; returns the
    number of entries moved.  (The quantized flash attention holds its
    int8 ctx output to the same form, with ``unit="ctx"``.)"""
    dq = (qp.to(torch.int32) - want_qp.to(torch.int32)).abs()
    moved = int((dq != 0).sum())
    worst = int(dq.max()) if dq.numel() else 0
    cap = max(8, int(MOVED_SHARE * dq.numel()))
    if worst > 1 or moved > cap:
        raise AssertionError(
            f"{what}: {moved} of {dq.numel()} {unit} quanta moved "
            f"(at most {cap} may), the largest move {worst} (at most 1)")
    return moved


def check_kernel(got, qp, q, k_pool, v_pool, table, pos, score_scale, *,
                 group: int = 1, k_rq=None, v_rq=None, what: str = ""
                 ) -> Tuple[int, int]:
    """The stated tolerance of a kernel output ``got`` and its
    probability image ``qp`` against the plain version on the same
    inputs (either pool mode): the image within `check_image`, ``got``
    equal to the plain integer P.V over the kernel's own image and the
    (unpacked) V view exactly, and equal to the plain output wherever
    the images agree.  Raises AssertionError; returns (quanta moved,
    max |got - plain output|)."""
    want, want_qp = paged_attention_plain(
        q, k_pool, v_pool, table, pos, score_scale, group=group,
        k_rq=k_rq, v_rq=v_rq, return_qp=True)
    moved = check_image(qp, want_qp, what)
    v_img = v_pool if v_rq is None else kv4_unpack(v_pool, v_rq)
    pv = torch.matmul(qp.to(torch.float64),
                      gathered_view(v_img, table, group).to(torch.float64))
    if not torch.equal(got, pv.to(torch.int32)):
        raise AssertionError(f"{what}: P.V differs from the plain product "
                             "over the kernel's own image")
    if moved == 0 and not torch.equal(got, want):
        raise AssertionError(f"{what}: equal images but unequal outputs")
    return moved, int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())


def staged_unpack_rq(n_kv_heads: int) -> torch.Tensor:
    """(6, K) int32 unpack operands (CPU) for checking the packed mode:
    m, s0, d and zp differ from kv head to kv head, with s0 > 0 on most
    heads, so a wrong head index or a wrong shift order changes the
    unpacked image."""
    cols = []
    for h in range(n_kv_heads):
        s0, d = h % 3, 6 + h % 2
        cols.append(((9 + 4 * h) * (1 << (d - s0)) + 3, s0, -8, 7, d, h % 2))
    return torch.tensor(cols, dtype=torch.int32).t().contiguous()


def paged_attention_plain(q, k_pool, v_pool, table, pos, score_scale, *,
                          group: int = 1, k_rq=None, v_rq=None,
                          return_qp: bool = False):
    if k_rq is not None:
        k_pool, v_pool = kv4_unpack(k_pool, k_rq), kv4_unpack(v_pool, v_rq)
    probs = attention_probs(q, k_pool, table, pos, score_scale, group=group)
    qp = torch.round(probs * 127.0)
    vh = gathered_view(v_pool, table, group)
    acc = torch.matmul(qp.to(torch.float64), vh.to(torch.float64))
    acc = acc.to(torch.int32)
    if return_qp:
        return acc, qp.to(torch.int8)
    return acc


def paged_attention(q, k_pool, v_pool, table, pos, score_scale, *,
                    group: int = 1, k_rq: Optional[torch.Tensor] = None,
                    v_rq: Optional[torch.Tensor] = None,
                    qp_out: Optional[torch.Tensor] = None):
    """Kernel wrapper; runs the plain version only for CPU tensors.

    Pools with a trailing axis hd/2 are int4-packed and need the
    (6, K) int32 unpack operands ``k_rq``/``v_rq``; int8 pools take
    none.  ``qp_out`` (CUDA only, optional): a (B, H, S, T) int8
    tensor the kernel fills with its probability image, for
    `check_image`.

    The wrapper knows no mesh: a kv-sharded rank
    (`layers.attention.QAttention.apply_id`) passes its own K / n kv
    heads' pools and unpack columns with their contiguous H / n query
    heads, and gets that head range, each (b, h) equal to the
    whole-pool call's."""
    B, H, S, hd = q.shape
    n_pool, K, ps, hd_store = k_pool.shape
    pps = table.shape[1]
    if v_pool.shape != k_pool.shape:
        raise ValueError("K and V pools must have one shape")
    packed = hd_store != hd
    if packed:
        if 2 * hd_store != hd or k_rq is None or v_rq is None:
            raise ValueError(
                f"pool head_dim {hd_store} != query head_dim {hd}: "
                "int4-packed pools need hd/2 cells plus k_rq/v_rq (6, K) "
                "requant operands")
        for rq in (k_rq, v_rq):
            if rq.shape != (6, K) or rq.dtype != torch.int32:
                raise ValueError("k_rq/v_rq must be (6, K) int32")
    elif k_rq is not None or v_rq is not None:
        raise ValueError("k_rq/v_rq given but the pools are not packed")
    if H != K * group:
        raise ValueError(f"H={H} != K={K} * group={group}")
    if (q.dtype != torch.int8 or k_pool.dtype != torch.int8
            or v_pool.dtype != torch.int8):
        raise ValueError("q and pools must be int8")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("table and pos must be int32")
    if table.shape[0] != B or pos.shape != (B,):
        raise ValueError("table (B, pps) and pos (B,) must match q")
    if score_scale.dtype != torch.float32 or score_scale.numel() != 1:
        raise ValueError("score_scale must be a float32 scalar tensor")
    if q.device.type == "cpu":
        if qp_out is not None:
            raise ValueError("qp_out is a CUDA-kernel diagnostic")
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     score_scale, group=group, k_rq=k_rq,
                                     v_rq=v_rq)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    rqs = (k_rq, v_rq) if packed else ()
    for t in (q, k_pool, v_pool, table, pos, score_scale, *rqs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    # pool rows are hd_store bytes, read as 16-byte vectors
    if hd_store % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pool rows must be 16-byte multiples, 16-byte "
                         "aligned")
    if q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned")
    T = pps * ps
    if qp_out is not None and (
            qp_out.shape != (B, H, S, T) or qp_out.dtype != torch.int8
            or qp_out.device != dev or not qp_out.is_contiguous()):
        raise ValueError("qp_out must be a contiguous (B, H, S, T) int8")
    plan = paged_plan(B, K, group, S, hd, ps, pps, packed)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"{plan.smem} bytes of shared memory do not fit")
    out = torch.empty((B, H, S, hd), dtype=torch.int32, device=dev)
    err = build.launcher("paged_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        pos.data_ptr(), score_scale.data_ptr(), out.data_ptr(),
        None if qp_out is None else qp_out.data_ptr(),
        k_rq.data_ptr() if packed else None,
        v_rq.data_ptr() if packed else None,
        B, H, S, hd, K, ps, pps, group, n_pool, plan.smem, plan.rows,
        plan.stages, int(plan.logits == "shared"),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_attention")
    (paged_attention_kv4 if packed else paged_attention).launches += 1
    return out


paged_attention.launches = 0
# launches over int4-packed pools count here, as a kernel row of their own
paged_attention_kv4 = SimpleNamespace(launches=0)
