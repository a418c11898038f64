"""int8 GEMM with a fused requant epilogue (port of
`repro.kernels.int8_matmul`; CUDA source csrc/int8_matmul.cu).

`int8_matmul(x, w, bias, rqt)` computes ``acc = x @ w + bias`` in
int32 and then either returns it (``rqt=None``, the int32-out mode the
wo/wd/head sites use) or applies the site's full `apply_rqt` to it and
returns int8 (the q/k/v, up and gate sites).  On a CPU tensor it runs
`int8_matmul_plain`; on a CUDA tensor it launches the kernel or raises.

Weight layout: the kernel reads the weights transposed, (N, K)
row-major.  The port stores every QLinear weight that way from the
moment its tables are loaded (`models.lm.tables_from_numpy`), as a
(K, N) tensor with strides (1, K), so the logical shape, dtype and
values stay those of the reference's `w_q`.

Grouped form (the MoE's expert GEMMs): `int8_matmul_grouped(x, w, rqt)`
multiplies x (G, E, C, K) by w (E, K, N) expert by expert, ``x[g, e] @
w[e]``, with the requant tables per (expert, channel), in ONE launch
over all G x E groups; `int8_matmul_grouped_plain` beside it.  The
reference leaves these products to jnp.einsum (`layers/moe.py`); torch
has no int8 x int8 -> int32 batched product on CUDA, so the GEMM kernel
carries them, each group through the same path as a dense product of C
rows.

Launch plan: `gemm_plan(M, N, K, groups)` picks the kernel's path (the
GEMV for M <= 16, the wgmma pipeline above), its tile and how many
blocks split K, so that every shape of the serving path fills the card.  Split K
keeps each block's partial tile in a workspace slot, which the tile's
last block sums; the wrapper allocates the workspace and the tile
counters once per device and stream, and the kernel leaves the
counters zeroed.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.requant import apply_rqt
from repro_torch.kernels import build

# K per float32 product: |int8 * int8| <= 2^14, so every partial sum of
# 1024 terms is an integer of at most 2^24, which float32 holds exactly
_F32_EXACT_K = 1 << 10


def _wrap_int32(a: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (XLA int32 semantics)."""
    a = torch.bitwise_and(a, 0xFFFFFFFF)
    return torch.where(a >= 2 ** 31, a - 2 ** 32, a).to(torch.int32)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      rqt: Optional[dict] = None, *, qmin: int = -128,
                      qmax: int = 127) -> torch.Tensor:
    """Plain PyTorch version.  The product runs in float32 over slices
    of _F32_EXACT_K along K, each exact in any summation order (every
    partial sum is an integer of at most 2^24; at full float32
    precision, torch's default, which the function checks), the slices
    added in int64 (torch has no integer matmul on CUDA, and its
    CPU int8 matmul returns int8).  The bias is added and the result
    wrapped to int32 like the reference's int32 accumulator."""
    if torch.get_float32_matmul_precision() != "highest":
        raise ValueError("the plain int8 GEMM needs full float32 "
                         "matmuls (float32_matmul_precision 'highest')")
    K = x.shape[-1]
    xf = x.to(torch.float32)
    acc = bias.to(torch.int64).expand(x.shape[0], -1).clone()
    for k0 in range(0, K, _F32_EXACT_K):
        k1 = min(k0 + _F32_EXACT_K, K)
        acc += torch.matmul(xf[:, k0:k1],
                            w[k0:k1].to(torch.float32)).to(torch.int64)
    acc = _wrap_int32(acc)
    if rqt is None:
        return acc
    return apply_rqt(acc, rqt, qmin=qmin, qmax=qmax, out_dtype=torch.int8)


SMS = 132                  # streaming multiprocessors of an H100 SXM
GEMV_BK = 512              # GEMV K step: one 16-byte vector per lane
WGMMA_BK = 128             # wgmma K step: one 128-byte swizzle atom
# bytes of K one wgmma block covers at most: past it, splitting K over
# more blocks was the faster plan on an H100 (PERF.md)
WGMMA_K_MAX = 4096
GEMV_ROWS = (1, 2, 4, 8, 16)
GEMV_COLS = (32, 16, 8, 4)  # 4 columns per warp, 8 .. 1 warps
WGMMA_TILES = ((128, 64), (64, 32))


class GemmPlan(NamedTuple):
    path: str      # "gemv" (M <= 16) or "wgmma"
    bm: int        # rows: the GEMV's compiled rows, or the tile's
    bn: int        # output columns per block
    bk: int        # bytes of K per step
    splits: int    # blocks along K
    k_split: int   # bytes of K per split, a whole number of steps
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_k(tiles: int, ksteps: int, cap: int) -> Tuple[int, int]:
    """-> (splits, steps per split): the fewest splits that give at
    least SMS blocks, each at most `cap` steps; all steps when even
    that falls short."""
    need = _cdiv(SMS, tiles)
    for s in range(need, ksteps + 1):
        sps = min(cap, _cdiv(ksteps, s))
        if _cdiv(ksteps, sps) >= need:
            return _cdiv(ksteps, sps), sps
    return ksteps, 1


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, groups: int = 1) -> GemmPlan:
    """Path, tile and split of K for an (M, K) @ (K, N) product.

    M <= 16 takes the GEMV, compiled for 1, 2, 4, 8 or 16 rows of x.
    Larger M takes the wgmma pipeline over one of WGMMA_TILES (128 rows
    only for M > 64), each block over at most WGMMA_K_MAX bytes of K.
    Of the plans that put at least SMS blocks on the card, the one with
    the fewest splits wins, then the widest GEMV block or the first
    wgmma tile; where none reaches SMS blocks, the one with the most.
    `groups` products of M rows each (the grouped form) count as that
    many times the tiles."""
    if M <= 16:
        path, bk = "gemv", GEMV_BK
        rows = next(t for t in GEMV_ROWS if t >= M)
        cap = _cdiv(K, bk)
        tiles = [(rows, bn, groups * _cdiv(N, bn)) for bn in GEMV_COLS]
    else:
        path, bk = "wgmma", WGMMA_BK
        cap = WGMMA_K_MAX // bk
        tiles = [(bm, bn, groups * _cdiv(M, bm) * _cdiv(N, bn))
                 for bm, bn in WGMMA_TILES if bm == 64 or M > 64]
    ksteps = _cdiv(K, bk)
    plans = []
    for bm, bn, n in tiles:
        splits, sps = _split_k(n, ksteps, cap)
        plans.append(GemmPlan(path, bm, bn, bk, splits, sps * bk,
                              n * splits))
    full = [p for p in plans if p.blocks >= SMS]
    if not full:
        return max(plans, key=lambda p: p.blocks)
    return min(full, key=lambda p: p.splits)


# split-K workspace (a slot per tile and split) and tile counters, per
# (device, stream); the counters are zeroed when allocated and left
# zeroed by every launch
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, plan: GemmPlan):
    tiles = plan.blocks // plan.splits
    n_ws = plan.blocks * plan.bm * plan.bn
    key = (device.index, stream)
    ws, count = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_ws or count.numel() < tiles:
        n_ws = max(n_ws, 0 if ws is None else ws.numel())
        tiles = max(tiles, 0 if count is None else count.numel())
        ws = torch.empty(n_ws, dtype=torch.int32, device=device)
        count = torch.zeros(tiles, dtype=torch.int32, device=device)
        _WORKSPACE[key] = (ws, count)
    return ws.data_ptr(), count.data_ptr()


def _rq_operands(rqt: dict, N: int, device, experts: int = 1):
    """-> (the m, s0, lo, hi tables, per-channel flag); with `experts`
    (the grouped form) the tables may also be (experts, N)."""
    tabs = [rqt[k] for k in ("m", "s0", "lo", "hi")]
    n = tabs[0].numel()
    if (n not in (1, N, experts * N) or any(t.numel() != n for t in tabs)
            or (n == experts * N > N and tabs[0].shape != (experts, N))):
        raise ValueError(f"requant tables must be scalar, ({N},) or "
                         f"({experts}, {N})")
    for t in tabs + [rqt["d"], rqt["zp"]]:
        if (t.device != device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("requant tables must be contiguous int32 "
                             "tensors on the input's device")
    if rqt["d"].numel() != 1 or rqt["zp"].numel() != 1:
        raise ValueError("requant d and zp must be scalars")
    return tabs, int(n >= N and N > 1)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                rqt: Optional[dict] = None, *, qmin: int = -128,
                qmax: int = 127) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 + bias (N,) int32.

    -> (M, N) int32 when ``rqt`` is None, else (M, N) int8 after the
    site's requant (m/s0/lo/hi scalar or (N,), d/zp scalar, all int32
    on the device).  Runs the plain version only for CPU tensors."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError("x and w must be int8")
    M, K = x.shape
    N = w.shape[1]
    if bias.dtype != torch.int32 or bias.shape != (N,):
        raise ValueError(f"bias must be int32 ({N},)")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, bias, rqt, qmin=qmin, qmax=qmax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("x, w and bias must share a device")
    if x.stride(1) != 1 or x.stride(0) < K:
        raise ValueError("x must be row-major with unit column stride")
    if w.stride() != (1, K):
        raise ValueError(
            "w must be stored transposed ((K, N) with strides (1, K)); "
            "models.lm.tables_from_numpy lays weights out so")
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    # both paths read 16-byte vectors of both operands
    if (K % 16 or x.stride(0) % 16 or x.data_ptr() % 16
            or w.data_ptr() % 16):
        raise ValueError(f"K={K} must be a multiple of 16 and the rows of "
                         "x and w 16-byte aligned")
    out_dtype = torch.int32 if rqt is None else torch.int8
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if rqt is None:
        ptrs = [None] * 6
        stride = 0
    else:
        tabs, stride = _rq_operands(rqt, N, x.device)
        ptrs = [t.data_ptr() for t in tabs] + [
            rqt["d"].data_ptr(), rqt["zp"].data_ptr()]
    plan = gemm_plan(M, N, K)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = count = None
    if plan.splits > 1:
        ws, count = _workspace(x.device, stream, plan)
    err = build.launcher("int8_matmul")(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), *ptrs, stride, qmin,
        qmax, out.data_ptr(), int(rqt is not None), M, N, K, x.stride(0),
        1, 1, 0, int(plan.path == "wgmma"), plan.bm, plan.bn, plan.splits,
        plan.k_split, ws, count, stream)
    build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    key = (M, K, N, "int32" if rqt is None else "int8")
    int8_matmul.by_shape[key] = int8_matmul.by_shape.get(key, 0) + 1
    return out


int8_matmul.launches = 0
# launches by (M, K, N, output type), counted beside `launches`
int8_matmul.by_shape = {}


def int8_matmul_grouped_plain(x: torch.Tensor, w: torch.Tensor,
                              rqt: Optional[dict] = None, *,
                              qmin: int = -128,
                              qmax: int = 127) -> torch.Tensor:
    """Plain PyTorch version of the grouped form: for every group,
    ``x[g, e] @ w[e]`` in the float32 slices of _F32_EXACT_K along K that
    `int8_matmul_plain` uses (each exact), added in int64 and wrapped to
    int32; then the requant with (E, N) tables broadcast over G and C."""
    if torch.get_float32_matmul_precision() != "highest":
        raise ValueError("the plain int8 GEMM needs full float32 "
                         "matmuls (float32_matmul_precision 'highest')")
    G, E, C, K = x.shape
    N = w.shape[-1]
    xf = x.to(torch.float32)
    acc = torch.zeros((G, E, C, N), dtype=torch.int64, device=x.device)
    for k0 in range(0, K, _F32_EXACT_K):
        k1 = min(k0 + _F32_EXACT_K, K)
        acc += torch.matmul(xf[..., k0:k1],
                            w[:, k0:k1].to(torch.float32)).to(torch.int64)
    acc = _wrap_int32(acc)
    if rqt is None:
        return acc
    rq = {k: (v[:, None, :] if v.dim() == 2 else v) for k, v in rqt.items()}
    return apply_rqt(acc, rq, qmin=qmin, qmax=qmax, out_dtype=torch.int8)


def int8_matmul_grouped(x: torch.Tensor, w: torch.Tensor,
                        rqt: Optional[dict] = None, *, qmin: int = -128,
                        qmax: int = 127) -> torch.Tensor:
    """x (G, E, C, K) int8 contiguous, w (E, K, N) int8 stored (E, N, K)
    -> (G, E, C, N): ``x[g, e] @ w[e]`` in int32 (``rqt`` None), else
    int8 after the requant (m/s0/lo/hi scalar, (N,) or (E, N); d and zp
    scalar).  One launch over all G x E groups; runs the plain version
    only for CPU tensors."""
    if x.dim() != 4 or w.dim() != 3 or x.shape[1] != w.shape[0] or (
            x.shape[3] != w.shape[1]):
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError("x and w must be int8")
    G, E, C, K = x.shape
    N = w.shape[2]
    if x.device.type == "cpu":
        return int8_matmul_grouped_plain(x, w, rqt, qmin=qmin, qmax=qmax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("x and w must share a device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (G, E, C, K)")
    if w.stride() != (N * K, 1, K):
        raise ValueError(
            "w must be stored transposed per expert ((E, K, N) with strides "
            "(N K, 1, K)); models.lm.tables_from_numpy lays weights out so")
    if K % 16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"K={K} must be a multiple of 16 and x and w "
                         "16-byte aligned")
    out_dtype = torch.int32 if rqt is None else torch.int8
    out = torch.empty((G, E, C, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if rqt is None:
        ptrs, stride, gstride = [None] * 6, 0, 0
    else:
        tabs, stride = _rq_operands(rqt, N, x.device, experts=E)
        gstride = N if tabs[0].numel() == E * N and E > 1 else 0
        ptrs = [t.data_ptr() for t in tabs] + [
            rqt["d"].data_ptr(), rqt["zp"].data_ptr()]
    plan = gemm_plan(C, N, K, G * E)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = count = None
    if plan.splits > 1:
        ws, count = _workspace(x.device, stream, plan)
    err = build.launcher("int8_matmul")(
        x.data_ptr(), w.data_ptr(), None, *ptrs, stride, qmin, qmax,
        out.data_ptr(), int(rqt is not None), C, N, K, K, G * E, E, gstride,
        int(plan.path == "wgmma"), plan.bm, plan.bn, plan.splits,
        plan.k_split, ws, count, stream)
    build.check(err, "int8_matmul_grouped")
    int8_matmul_grouped.launches += 1
    key = (G * E, C, K, N, "int32" if rqt is None else "int8")
    int8_matmul_grouped.by_shape[key] = (
        int8_matmul_grouped.by_shape.get(key, 0) + 1)
    return out


int8_matmul_grouped.launches = 0
# launches by (groups, C, K, N, output type)
int8_matmul_grouped.by_shape = {}
