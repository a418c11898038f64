"""Add of two residual branches, ID path (port of
`repro.layers.add.QAdd`, Eq. 24).

Each branch is requantized into the fresh symmetric output space as an
int32 image clipped to +-2^24 (the requant kernel's int32-out mode),
the two are summed in int32 and clipped once to int8.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import requant
from repro_torch.layers.common import ACT_QMAX, ACT_QMIN, DeployCtx

_BRANCH = 1 << 24


@dataclasses.dataclass(frozen=True)
class QAdd:
    name: str = "add"

    def deploy(
        self, ctx: DeployCtx, scope: str,
        eps_a: float, zp_a: int, eps_b: float, zp_b: int,
    ) -> Tuple[dict, float, int]:
        """-> (tables, eps_s, zp_s=0)."""
        lo, hi = ctx.range(f"{scope}{self.name}", "resid")
        amax = max(abs(lo), abs(hi), 1e-6)
        eps_s = 2.0 * amax / 255.0
        rq_a = make_rqt(eps_a, eps_s, zp_out=0, qmin=-_BRANCH, qmax=_BRANCH,
                        requant_factor=ctx.factor, acc_bound=float(1 << 16))
        rq_b = make_rqt(eps_b, eps_s, zp_out=0, qmin=-_BRANCH, qmax=_BRANCH,
                        requant_factor=ctx.factor, acc_bound=float(1 << 16))
        return (
            {"rq_a": rq_a, "rq_b": rq_b,
             "zp_a": np.int32(zp_a), "zp_b": np.int32(zp_b)},
            eps_s,
            0,
        )

    def apply_id(self, t: dict, s_a: torch.Tensor,
                 s_b: torch.Tensor) -> torch.Tensor:
        """Branches (int8 images or int32 accumulators, any zp) ->
        symmetric int8 sum."""
        qa = (s_a.to(torch.int32) - t["zp_a"].to(torch.int32)).contiguous()
        qb = (s_b.to(torch.int32) - t["zp_b"].to(torch.int32)).contiguous()
        ya = requant(qa, t["rq_a"], qmin=-_BRANCH, qmax=_BRANCH,
                     out_dtype=torch.int32)
        yb = requant(qb, t["rq_b"], qmin=-_BRANCH, qmax=_BRANCH,
                     out_dtype=torch.int32)
        return (ya + yb).clamp(ACT_QMIN, ACT_QMAX).to(torch.int8)
