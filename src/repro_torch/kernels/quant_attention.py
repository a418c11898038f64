"""Quantized flash attention (port of `repro.kernels.quant_attention`
and of its GQA entry point `repro.kernels.ops.quant_flash_attention`;
CUDA source csrc/quant_attention.cu).

Streams over KV blocks with an online softmax and a PER-BLOCK int8
probability image:

    per KV block j (bkv keys):
      s      = q_i8 . k_j_i8^T                     int32
      logits = s * score_scale, masked by REPLACEMENT with -1e9
      m_new  = max(m, rowmax(logits))
      p      = exp(logits - m_new)
      qp     = rint(127 p)                         int8 image
      corr   = exp(m - m_new)
      acc    = acc * corr + (qp . v_j) * (1/127)   int32 P.V, f32 acc
      l      = l * corr + sum(qp) * (1/127)
    out_i8 = clip(rint(acc / max(l, 1e-9) * (1/eps_ctx)), -128, 127)

Every constant is the float32 of its double (score_scale, 1/127,
1/eps_ctx), and every float step rounds once, in this order — the
Pallas kernel's `* (1/127)`, which the plain version follows too (the
reference's jnp mirror divides by 127 instead).  This is not the
model's attention: the probabilities are requantized per block, so no
model path calls it; it is an entry point of its own.

`quant_flash_attention` is the GQA wrapper: q (B, H, S_q, hd), k/v (B,
K, S_kv, hd) int8, H = K * n_rep -> (B, H, S_q, hd) int8.  S_q is
padded to bq with zero rows (their output is dropped), in both the
kernel's and the plain version's path; S_kv must divide by bkv.  With
`causal`, query row i sits at position q_offset + i and sees keys at
positions <= its own; q_offset must be >= 0, so key 0 is in every
row's horizon.

`quant_flash_attention_plain` is the port of
`repro.kernels.ref.quant_flash_attention_ref` with the kernel's float
order, batched over (B, H, query block) with a Python loop over the KV
blocks; integer products run in float64, exact at these ranges.

On the card the wrapper launches one of two kernels of
csrc/quant_attention.cu, chosen by `qfa_plan` from the shape alone:
the tensor-core kernel (int8 `mma.sync` for both products, 4 warps of
16 query rows, up to 4 query heads of one kv head per block) for bkv
in `MMA_BKV`, and the first, CUDA-core kernel for every other bkv.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e9
_SMEM_LIMIT = 220 * 1024  # of the 227 KB a block may opt into
HEAD_DIMS = (32, 64, 128, 192)  # the kernels' compiled head widths
MMA_BKV = (32, 64, 128)  # the tensor-core kernel's compiled KV blocks
MMA_WARPS = 4  # warps of 16 query rows in one tensor-core block


def _f32(x: float) -> float:
    """The float32 of a Python float, as a Python float."""
    return float(np.float32(x))


def quant_flash_attention_plain(q, k, v, *, score_scale: float,
                                eps_ctx: float, causal: bool = True,
                                q_offset: int = 0, n_rep: int = 1,
                                bq: int = 128, bkv: int = 128):
    """q (B, H, S_q, hd) int8; k/v (B, K, S_kv, hd) int8 with S_kv a
    multiple of bkv -> (B, H, S_q, hd) int8 (S_q padded to bq inside)."""
    S_out = q.shape[2]
    q = torch.nn.functional.pad(q, (0, 0, 0, (-S_out) % bq))
    B, H, S_q, hd = q.shape
    S_kv = k.shape[2]
    n_q, n_kv = S_q // bq, S_kv // bkv
    dev = q.device
    f32 = torch.float32
    kr = k.repeat_interleave(n_rep, dim=1)
    vr = v.repeat_interleave(n_rep, dim=1)
    qb = q.reshape(B, H, n_q, bq, hd).to(torch.float64)
    scale = torch.tensor(_f32(score_scale), dtype=f32, device=dev)
    inv127 = torch.tensor(_f32(1.0 / 127.0), dtype=f32, device=dev)
    inv_eps = torch.tensor(_f32(1.0 / eps_ctx), dtype=f32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    m = torch.full((B, H, n_q, bq), NEG_INF, dtype=f32, device=dev)
    l_run = torch.zeros((B, H, n_q, bq), dtype=f32, device=dev)
    acc = torch.zeros((B, H, n_q, bq, hd), dtype=f32, device=dev)
    q_pos = q_offset + torch.arange(S_q, device=dev).reshape(n_q, bq, 1)
    for j in range(n_kv):
        kb = kr[:, :, None, j * bkv:(j + 1) * bkv].to(torch.float64)
        vb = vr[:, :, None, j * bkv:(j + 1) * bkv].to(torch.float64)
        s = torch.matmul(qb, kb.transpose(-1, -2)).to(torch.int32)
        logits = s.to(f32) * scale
        if causal:
            k_pos = j * bkv + torch.arange(bkv, device=dev)
            logits = torch.where(k_pos <= q_pos, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        qp = torch.round(p * 127.0)
        pv = torch.matmul(qp.to(torch.float64), vb).to(torch.int32)
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + pv.to(f32) * inv127
        l_run = l_run * corr + qp.sum(dim=-1) * inv127
        m = m_new
    ctx = acc / torch.maximum(
        l_run, torch.tensor(1e-9, dtype=f32, device=dev))[..., None]
    out = torch.round(ctx * inv_eps).clamp(-128, 127).to(torch.int8)
    return out.reshape(B, H, S_q, hd)[:, :, :S_out]


class QfaPlan(NamedTuple):
    """How the wrapper launches the kernel for one shape."""
    path: str               # "mma" (tensor cores) or "simt" (CUDA cores)
    heads: int              # query heads of one kv head in a block
    rows: int               # query rows of each head in a block
    skip: bool              # the kernel may skip causal blocks past
                            # a tile
    smem: int               # dynamic shared bytes of a block


def qfa_plan(n_rep: int, hd: int, bq: int, bkv: int, causal: bool,
             score_scale: float) -> QfaPlan:
    """The launch for one shape.  bkv in MMA_BKV takes the tensor-core
    kernel: the largest of 4, 2, 1 query heads that divides n_rep share
    a block's K/V loads, and the block's 4 warps cover 64 / heads query
    rows; shared memory is the double-buffered K and V ring, bkv rows
    of hd + 16 bytes each, and V^T, hd rows of bkv + 16 bytes.  Any
    other bkv takes the CUDA-core kernel, a block per (bq rows, query
    head), S_q padded to bq.  Skipping causal blocks is exact while key
    0's logit stays above -1e9 (csrc note 3): |s| < 128 * 128 * hd."""
    skip = bool(causal) and abs(_f32(score_scale)) * 128 * 128 * hd < 1e9
    if bkv in MMA_BKV:
        heads = next(w for w in (4, 2, 1) if n_rep % w == 0)
        rows = 16 * (MMA_WARPS // heads)
        smem = 4 * bkv * (hd + 16) + hd * (bkv + 16)
        return QfaPlan("mma", heads, rows, skip, smem)
    # CUDA-core layout: q | int8 image | f32 logits, later the V block |
    # f32 acc | m, l, corr
    smem = (bq * hd + 16 * ((bq * bkv + 15) // 16)
            + 16 * ((max(4 * bq * bkv, bkv * hd) + 15) // 16)
            + 4 * bq * hd + 12 * bq)
    return QfaPlan("simt", 1, bq, skip, smem)


def quant_flash_attention(q, k, v, *, score_scale: float, eps_ctx: float,
                          causal: bool = True, q_offset: int = 0,
                          n_rep: int = 1, bq: int = 128, bkv: int = 128):
    """Kernel wrapper (the GQA entry point); runs the plain version only
    for CPU tensors, launches a kernel or raises for CUDA ones.  Which
    kernel, and its tile, is `qfa_plan`'s choice from the shape alone:
    the tensor-core kernel for bkv in MMA_BKV, the CUDA-core kernel for
    any other bkv — never because a launch failed."""
    B, H, S_q, hd = q.shape
    Bk, K, S_kv, hd_k = k.shape
    if v.shape != k.shape or Bk != B or hd_k != hd:
        raise ValueError("k/v must be (B, K, S_kv, hd) matching q")
    if H != K * n_rep:
        raise ValueError(f"H={H} != K={K} * n_rep={n_rep}")
    if q.dtype != torch.int8 or k.dtype != torch.int8 or \
            v.dtype != torch.int8:
        raise ValueError("q, k and v must be int8")
    if bq < 1 or bkv < 1 or S_kv % bkv:
        raise ValueError(f"S_kv={S_kv} must be a multiple of bkv={bkv}")
    if causal and q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    if q.device.type == "cpu":
        return quant_flash_attention_plain(
            q, k, v, score_scale=score_scale, eps_ctx=eps_ctx, causal=causal,
            q_offset=q_offset, n_rep=n_rep, bq=bq, bkv=bkv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    plan = qfa_plan(n_rep, hd, bq, bkv, causal, score_scale)
    pad = (-S_q) % bq if plan.path == "simt" else 0
    q = (torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q
         ).contiguous()
    for t in (k, v):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("k and v must be 16-byte aligned, q 4-byte "
                         "aligned")
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"bq={bq} bkv={bkv} hd={hd} need {plan.smem} "
                         "bytes of shared memory")
    S_qp = S_q + pad
    out = torch.empty((B, H, S_qp, hd), dtype=torch.int8, device=dev)
    err = build.launcher("quant_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _f32(score_scale), _f32(1.0 / 127.0), _f32(1.0 / eps_ctx),
        B, H, K, n_rep, S_qp, S_kv, hd, bq, bkv, q_offset, int(causal),
        int(plan.path == "mma"), plan.heads, int(plan.skip), plan.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "quant_attention")
    quant_flash_attention.launches += 1
    return out[:, :, :S_q]


quant_flash_attention.launches = 0
