"""Standalone requantization (port of `repro.kernels.requant_kernel`;
CUDA source csrc/requant.cu).

`requant(q, rqt)` is `core.requant.apply_rqt` with the same contract:
int32 input of any shape, per-channel tables along the last axis (or
scalars), `d` and `zp` read on the device, int8 or int32 output.  On a
CPU tensor it runs `apply_rqt` (its plain version); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.requant import apply_rqt
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import _rq_operands


def requant(q: torch.Tensor, rqt: dict, *, qmin: int = -128,
            qmax: int = 127, out_dtype: torch.dtype = torch.int8
            ) -> torch.Tensor:
    if q.dtype != torch.int32:
        raise ValueError("requant input must be int32")
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError("requant output must be int8 or int32")
    if q.device.type == "cpu":
        return apply_rqt(q, rqt, qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not q.is_contiguous():
        raise ValueError("requant input must be contiguous")
    N = q.shape[-1] if q.dim() else 1
    tabs, stride = _rq_operands(rqt, N, q.device)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    err = build.launcher("requant")(
        q.data_ptr(), *[t.data_ptr() for t in tabs], stride,
        rqt["d"].data_ptr(), rqt["zp"].data_ptr(), qmin, qmax,
        out.data_ptr(), int(out_dtype == torch.int8), q.numel(), N,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "requant")
    requant.launches += 1
    return out


requant.launches = 0
