"""The Quantization/Activation operator, ID path (port of
`repro.layers.act_quant.QAct`: `deploy` and `apply_id` for IDENTITY
and the LUT kinds SILU/GELU).

IDENTITY is a pure requantization (Eq. 11); SILU requantizes into a
symmetric pre-activation int8 space and reads a 256-entry LUT.  On the
dense path both requants run fused into the producing GEMM's epilogue
(`QLinear.apply_id(..., rqt)`); `apply_id` here is the unfused form.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.intmath import apply_lut, build_lut
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import requant
from repro_torch.layers.common import (
    ACT_QMAX, ACT_QMIN, ActKind, DeployCtx, act_fn_np,
)


@dataclasses.dataclass(frozen=True)
class QAct:
    kind: ActKind = ActKind.IDENTITY
    n_bits: int = 8
    name: str = "act"
    sym: bool = False
    range_scale: float = 1.0

    def deploy(
        self,
        ctx: DeployCtx,
        scope: str,
        eps_in,
        zp_in: int,
        acc_bound: float,
    ) -> Tuple[dict, float, int]:
        """-> (tables, eps_out, zp_out)."""
        full = f"{scope}{self.name}"
        if self.kind is ActKind.IDENTITY:
            lo, hi = ctx.range(full, "resid")
            lo, hi = lo * self.range_scale, hi * self.range_scale
            if self.sym:
                amax = max(abs(lo), abs(hi), 1e-6)
                lo, hi = -amax, amax
            hi = max(hi, lo + 1e-6)
            eps_y = (hi - lo) / (2 ** self.n_bits - 1)
            zp = 0 if self.sym else ACT_QMIN - int(round(lo / eps_y))
            rqt = make_rqt(
                eps_in, eps_y, zp_out=zp, qmin=ACT_QMIN, qmax=ACT_QMAX,
                requant_factor=ctx.factor, acc_bound=acc_bound,
            )
            return {"rqt": rqt}, eps_y, zp
        if self.kind not in (ActKind.SILU, ActKind.GELU):
            raise NotImplementedError(
                f"{self.kind} is outside the dense serving slice")
        lo_in, hi_in = ctx.range(f"{full}.pre", "attn")
        amax = max(abs(lo_in), abs(hi_in), 1e-6)
        eps_pre = 2.0 * amax / (2 ** self.n_bits - 1)
        rqt = make_rqt(
            eps_in, eps_pre, zp_out=0, qmin=ACT_QMIN, qmax=ACT_QMAX,
            requant_factor=ctx.factor, acc_bound=acc_bound,
        )
        lo, hi = ctx.range(full, "act_asym")
        hi = max(hi, lo + 1e-6)
        eps_y = (hi - lo) / (2 ** self.n_bits - 1)
        zp = ACT_QMIN - int(round(lo / eps_y))
        lut = build_lut(
            lambda v: act_fn_np(self.kind, v), eps_pre, 0, eps_y, zp,
            qmin=ACT_QMIN, qmax=ACT_QMAX,
        )
        return {"rqt": rqt, "lut": lut}, eps_y, zp

    def apply_lut(self, tables: dict, s: torch.Tensor) -> torch.Tensor:
        """The LUT half of a SILU/GELU site (after its requant)."""
        return apply_lut(s, tables["lut"], qmin=ACT_QMIN)

    def apply_id(self, tables: dict, acc: torch.Tensor) -> torch.Tensor:
        s = requant(acc.to(torch.int32).contiguous(), tables["rqt"])
        if self.kind is ActKind.IDENTITY:
            return s
        return self.apply_lut(tables, s)
