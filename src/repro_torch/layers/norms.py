"""Integer RMSNorm, ID path (port of `repro.layers.norms.QNorm`, the
rms kind: `deploy` and `apply_id`).

The per-token normalizer enters as a dynamic fixed-point reciprocal
(see the reference's module doc).  Every step is int32 and mirrors the
reference operation for operation, wraps and shift clips included;
the tests hold it at tolerance 0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.intmath import bit_length, int_isqrt
from repro_torch.layers.common import ACT_QMAX, ACT_QMIN, DeployCtx

NORM_BITS = 14  # reciprocal mantissa bits


@dataclasses.dataclass(frozen=True)
class QNorm:
    d: int
    kind: str = "rms"
    eps: float = 1e-6
    use_bias: bool = False
    name: str = "norm"

    def __post_init__(self):
        if self.kind != "rms" or self.use_bias:
            raise NotImplementedError(
                "only the bias-free rms norm is in the dense serving slice")

    def init_np(self) -> dict:
        return {"g": np.ones((self.d,), np.float32)}

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_in: float
    ) -> Tuple[dict, float, int]:
        """-> (tables, eps_out, zp_out=0). Input must be symmetric."""
        g = np.asarray(p_np["g"], np.float64)
        beta_g = np.maximum(np.max(np.abs(g)), 1e-8)
        eps_g = 2.0 * beta_g / 255.0
        q_g = np.clip(np.floor(g / eps_g), -128, 127).astype(np.int8)
        lo, hi = ctx.range(f"{scope}{self.name}", "norm")
        amax = max(abs(lo), abs(hi), 1e-6)
        eps_y = 2.0 * amax / 255.0
        static = np.sqrt(self.d) * eps_g / eps_y
        sh = 16 - int(np.floor(np.log2(max(static, 1e-12)))) - 1
        m_static = int(np.floor(static * 2.0 ** sh))
        tables = {"g_q": q_g, "m": np.int32(m_static), "sh": np.int32(sh)}
        return tables, eps_y, 0

    def apply_id(self, t: dict, s: torch.Tensor) -> torch.Tensor:
        """s int8 (..., d), zp=0 -> int8 (..., d), zp=0."""
        s32 = s.to(torch.int32)
        ss = (s32 * s32).sum(dim=-1, keepdim=True, dtype=torch.int32)
        r = torch.clamp(int_isqrt(ss), min=1)
        e_r = bit_length(r) - 1
        zero = torch.zeros_like(e_r)
        r_n = torch.bitwise_left_shift(r, torch.maximum(NORM_BITS - e_r, zero))
        r_n = torch.bitwise_right_shift(
            r_n, torch.maximum(e_r - NORM_BITS, zero))
        recip = torch.div(
            torch.full_like(r_n, 1 << (2 * NORM_BITS + 1)),
            torch.clamp(r_n, min=1), rounding_mode="floor")
        g = t["g_q"].to(torch.int32)
        t1 = s32 * g
        t2 = torch.bitwise_right_shift(t1 * recip, NORM_BITS + 1)
        t3 = t2 * t["m"].to(torch.int32)
        shift = t["sh"].to(torch.int32) + e_r
        out = torch.bitwise_right_shift(t3, shift.clamp(0, 31))
        out = torch.bitwise_left_shift(out, (-shift).clamp(0, 31))
        out = torch.where(shift > 31, torch.zeros_like(out), out)
        return out.clamp(ACT_QMIN, ACT_QMAX).to(torch.int8)
