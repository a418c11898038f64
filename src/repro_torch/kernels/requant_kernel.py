"""Standalone requantization and the two sites built on it (port of
`repro.kernels.requant_kernel`; CUDA source csrc/requant.cu).

Three call forms, one launch each, every one equal bit for bit to the
plain PyTorch version beside it:

  requant(q, rqt, heads_to_rows=False)
      `core.requant.apply_rqt`: int32 in, any shape, tables scalar or
      per channel (the last axis), `d` and `zp` read on the device, int8
      or int32 out.  With `heads_to_rows` a (B, H, S, hd) input comes
      out laid out (B, S, H, hd): the attention's ctx_rqt, written the
      way the wo GEMM reads it.
  requant_add(s_a, s_b, t)
      the whole `QAdd.apply_id`: each branch minus its zp, requantised
      to int32 in +-2^24, the sum clipped to int8.
  requant_gate(s_pre, s_u, lut, zp_g, h_rqt)
      the gated MLP's tail: the SiLU LUT, (s_g - zp_g) * s_u in int32,
      then h_rqt to int8.

On a CPU tensor each runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Every launch counts on
`requant.launches`, split by form on `requant.by_form` ("rqt",
"rqt_heads", "add", "gate").  Where H or S is 1 the heads-to-rows
layout is q's own, and the launch skips the address map.

Launch plan: the kernel takes 16-element vectors where `vector_ok`
says the data allow it (16-byte aligned pointers; per-channel tables
and heads-to-rows rows in whole vectors); the elements past the last
whole vector, or all of them otherwise, take its scalar path in the same
launch.  `requant_plan` sizes the grid to the work.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.core.intmath import apply_lut
from repro_torch.core.requant import apply_rqt
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import _rq_operands

BRANCH = 1 << 24   # QAdd's int32 branch range, +-2^24
VEC = 16           # elements of one thread's vector
# threads a block and vectors a thread (PERF.md §6, row 3's sweep)
THREADS = 128
PER_THREAD = 1
_INT32_ELEMENTS = 1 << 31


class RequantPlan(NamedTuple):
    vec: bool      # 16-element vectors (else every element scalar)
    threads: int   # a block
    blocks: int


def vector_ok(data_ptrs: List[int], table_ptrs: List[int], N: int,
              whole_rows: bool) -> bool:
    """Whether the kernel may move 16-element vectors: every data
    pointer 16-byte aligned and, where the 16 elements of a vector must
    lie in one row (per-channel tables, heads-to-rows), rows of a whole
    number of vectors and 16-byte aligned tables."""
    if any(p % 16 for p in data_ptrs):
        return False
    return not whole_rows or (
        N % VEC == 0 and not any(p % 16 for p in table_ptrs))


def requant_plan(numel: int, vec: bool, threads: int = THREADS,
                 per_thread: int = PER_THREAD) -> RequantPlan:
    """One thread for every `per_thread` vectors (every `per_thread`
    elements on the scalar path), `threads` a block."""
    items = -(-numel // VEC) if vec else numel
    return RequantPlan(vec, threads, max(1, -(-items // (threads *
                                                          per_thread))))


def _on_card(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError("operands must share a device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if ts[0].numel() >= _INT32_ELEMENTS:
        raise ValueError("the requant kernel indexes in 32 bits: fewer "
                         f"than 2^31 elements, got {ts[0].numel()}")
    return dev


def _tables(rqt: dict, N: int, device):
    """-> (m, s0, lo, hi, d, zp pointers, per-channel flag, the
    per-channel tables' pointers)."""
    tabs, pc = _rq_operands(rqt, N, device)
    ptrs = [t.data_ptr() for t in tabs]
    return ptrs + [rqt["d"].data_ptr(), rqt["zp"].data_ptr()], pc, (
        ptrs if pc else [])


def _scalar_int32(t: torch.Tensor, what: str, device) -> None:
    if t.dtype != torch.int32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"{what} must be one int32 on the input's device")


def _count(form: str) -> None:
    requant.launches += 1
    requant.by_form[form] = requant.by_form.get(form, 0) + 1


def requant_plain(q: torch.Tensor, rqt: dict, *, qmin: int = -128,
                  qmax: int = 127, out_dtype: torch.dtype = torch.int8,
                  heads_to_rows: bool = False) -> torch.Tensor:
    out = apply_rqt(q, rqt, qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    return out.permute(0, 2, 1, 3).contiguous() if heads_to_rows else out


def requant(q: torch.Tensor, rqt: dict, *, qmin: int = -128,
            qmax: int = 127, out_dtype: torch.dtype = torch.int8,
            heads_to_rows: bool = False) -> torch.Tensor:
    if q.dtype != torch.int32:
        raise ValueError("requant input must be int32")
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError("requant output must be int8 or int32")
    if heads_to_rows and q.dim() != 4:
        raise ValueError("heads_to_rows takes a (B, H, S, hd) input")
    if q.device.type == "cpu":
        return requant_plain(q, rqt, qmin=qmin, qmax=qmax,
                             out_dtype=out_dtype, heads_to_rows=heads_to_rows)
    dev = _on_card(q)
    N = q.shape[-1] if q.dim() else 1
    tabs, pc, tab_ptrs = _tables(rqt, N, dev)
    B, H, S, hd = q.shape if heads_to_rows else (0, 0, 0, 0)
    out = torch.empty((B, S, H, hd) if heads_to_rows else q.shape,
                      dtype=out_dtype, device=dev)
    if q.numel() == 0:
        return out
    if 1 in (H, S):  # a singleton axis: (B, S, H, hd) is q's own order
        H = 0
    plan = requant_plan(q.numel(), vector_ok(
        [q.data_ptr(), out.data_ptr()], tab_ptrs, N, pc or H > 0))
    err = build.launcher("requant")(
        q.data_ptr(), *tabs, pc, qmin, qmax, out.data_ptr(),
        int(out_dtype == torch.int8), q.numel(), N, H, S, int(plan.vec),
        plan.threads, plan.blocks, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "requant")
    _count("rqt_heads" if heads_to_rows else "rqt")
    return out


def requant_add_plain(s_a: torch.Tensor, s_b: torch.Tensor,
                      t: dict) -> torch.Tensor:
    """`QAdd.apply_id`: t = {rq_a, rq_b, zp_a, zp_b}."""
    qa = s_a.to(torch.int32) - t["zp_a"].to(torch.int32)
    qb = s_b.to(torch.int32) - t["zp_b"].to(torch.int32)
    ya = apply_rqt(qa, t["rq_a"], qmin=-BRANCH, qmax=BRANCH,
                   out_dtype=torch.int32)
    yb = apply_rqt(qb, t["rq_b"], qmin=-BRANCH, qmax=BRANCH,
                   out_dtype=torch.int32)
    return (ya + yb).clamp(-128, 127).to(torch.int8)


def requant_add(s_a: torch.Tensor, s_b: torch.Tensor,
                t: dict) -> torch.Tensor:
    """Branches s_a (int8 or int32) and s_b (int32), each with its zp
    and requant tables in the QAdd table `t` -> the int8 sum."""
    if s_a.dtype not in (torch.int8, torch.int32) or s_b.dtype != torch.int32:
        raise ValueError("requant_add takes an int8 or int32 a and an int32 "
                         "b")
    if s_a.shape != s_b.shape:
        raise ValueError(f"branch shapes {tuple(s_a.shape)} and "
                         f"{tuple(s_b.shape)} differ")
    if s_a.device.type == "cpu":
        return requant_add_plain(s_a, s_b, t)
    dev = _on_card(s_a, s_b)
    N = s_a.shape[-1] if s_a.dim() else 1
    tabs_a, pc_a, ptrs_a = _tables(t["rq_a"], N, dev)
    tabs_b, pc_b, ptrs_b = _tables(t["rq_b"], N, dev)
    _scalar_int32(t["zp_a"], "zp_a", dev)
    _scalar_int32(t["zp_b"], "zp_b", dev)
    out = torch.empty(s_a.shape, dtype=torch.int8, device=dev)
    if s_a.numel() == 0:
        return out
    plan = requant_plan(s_a.numel(), vector_ok(
        [s_a.data_ptr(), s_b.data_ptr(), out.data_ptr()], ptrs_a + ptrs_b,
        N, bool(pc_a or pc_b)))
    err = build.launcher("requant_add")(
        s_a.data_ptr(), int(s_a.dtype == torch.int8), t["zp_a"].data_ptr(),
        *tabs_a, pc_a, s_b.data_ptr(), t["zp_b"].data_ptr(), *tabs_b, pc_b,
        out.data_ptr(), s_a.numel(), N, int(plan.vec), plan.threads,
        plan.blocks, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "requant_add")
    _count("add")
    return out


def requant_gate_plain(s_pre: torch.Tensor, s_u: torch.Tensor,
                       lut: torch.Tensor, zp_g: torch.Tensor,
                       h_rqt: dict) -> torch.Tensor:
    """The gated MLP's tail: SiLU LUT, gate product, h_rqt."""
    s_g = apply_lut(s_pre, lut, qmin=-128)
    prod = (s_g.to(torch.int32) - zp_g.to(torch.int32)) * s_u.to(
        torch.int32)
    return apply_rqt(prod, h_rqt)


def requant_gate(s_pre: torch.Tensor, s_u: torch.Tensor, lut: torch.Tensor,
                 zp_g: torch.Tensor, h_rqt: dict) -> torch.Tensor:
    """s_pre (the gate's int8 image before its LUT) and s_u (the up
    branch's int8 image) -> s_h int8: h_rqt of (lut[s_pre + 128] -
    zp_g) * s_u."""
    if s_pre.dtype != torch.int8 or s_u.dtype != torch.int8:
        raise ValueError("requant_gate takes int8 s_pre and s_u")
    if s_pre.shape != s_u.shape:
        raise ValueError(f"shapes {tuple(s_pre.shape)} and "
                         f"{tuple(s_u.shape)} differ")
    if lut.dtype != torch.int8 or lut.shape != (256,):
        raise ValueError("the LUT must be int8 (256,)")
    if s_pre.device.type == "cpu":
        return requant_gate_plain(s_pre, s_u, lut, zp_g, h_rqt)
    dev = _on_card(s_pre, s_u, lut)
    N = s_pre.shape[-1] if s_pre.dim() else 1
    tabs, pc, tab_ptrs = _tables(h_rqt, N, dev)
    _scalar_int32(zp_g, "zp_g", dev)
    out = torch.empty(s_pre.shape, dtype=torch.int8, device=dev)
    if s_pre.numel() == 0:
        return out
    plan = requant_plan(s_pre.numel(), vector_ok(
        [s_pre.data_ptr(), s_u.data_ptr(), out.data_ptr()], tab_ptrs, N,
        bool(pc)))
    err = build.launcher("requant_gate")(
        s_pre.data_ptr(), lut.data_ptr(), zp_g.data_ptr(), s_u.data_ptr(),
        *tabs, pc, out.data_ptr(), s_pre.numel(), N, int(plan.vec),
        plan.threads, plan.blocks, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "requant_gate")
    _count("gate")
    return out


requant.launches = 0
# launches by form (FORMS), counted beside `launches`
requant.by_form = {}
