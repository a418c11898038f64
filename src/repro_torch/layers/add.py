"""Add of two residual branches, ID path (port of
`repro.layers.add.QAdd`, Eq. 24).

Each branch is requantized into the fresh symmetric output space as an
int32 image clipped to +-2^24, the two are summed in int32 and clipped
once to int8: one launch of the requant kernel's add form.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import BRANCH, requant_add
from repro_torch.layers.common import DeployCtx


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
        rq_a = make_rqt(eps_a, eps_s, zp_out=0, qmin=-BRANCH, qmax=BRANCH,
                        requant_factor=ctx.factor, acc_bound=float(1 << 16))
        rq_b = make_rqt(eps_b, eps_s, zp_out=0, qmin=-BRANCH, qmax=BRANCH,
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
        return requant_add(s_a, s_b, t)
