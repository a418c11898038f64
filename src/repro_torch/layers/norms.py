"""RMSNorm and LayerNorm (port of `repro.layers.norms.QNorm`, both
kinds, with or without LayerNorm's bias: the float forward
`apply_fp` (FP and FQ; its math in float32, the output in the input's
dtype), `deploy` and the integer `apply_id`).

The per-token normalizer enters as a dynamic fixed-point reciprocal
(see the reference's module doc).  LayerNorm centres each token at
scale d first (c = d*s - sum(s), no integer division), shifts c down so
that sum(c^2) fits int32 (`_center_shifts`, constants of d alone), and
adds its bias image `b_q` before the final clip.  Every step is int32
and mirrors the reference operation for operation, wraps, arithmetic
shifts of negative values and shift clips included; the tests hold it
at tolerance 0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.intmath import bit_length, int_isqrt
from repro_torch.layers.common import ACT_QMAX, ACT_QMIN, DeployCtx

NORM_BITS = 14  # reciprocal mantissa bits


def _center_shifts(d: int) -> Tuple[int, int]:
    """LayerNorm's (c_shift, base_shift) at width d: c = d*s - sum(s)
    takes c_bits = ceil(log2(2 * 127 * d)) bits; c >> c_shift keeps
    bits_ok = (31 - ceil(log2 d)) // 2 of them, so sum(cq^2) < 2^31;
    base = cq >> base_shift keeps 8, so the reciprocal's multiply
    chain stays in int32 (d 128: 3 and 4; d 18432: 15 and 0)."""
    bits_ok = int((31 - np.ceil(np.log2(d))) // 2)
    c_bits = int(np.ceil(np.log2(2 * 127 * d)))
    c_shift = max(0, c_bits - bits_ok)
    return c_shift, max(0, c_bits - c_shift - 8)


@dataclasses.dataclass(frozen=True)
class QNorm:
    d: int
    kind: str = "rms"          # "rms" | "layer"
    eps: float = 1e-6
    use_bias: bool = False     # LayerNorm's beta
    name: str = "norm"

    def init_np(self) -> dict:
        p = {"g": np.ones((self.d,), np.float32)}
        if self.use_bias:
            p["b"] = np.zeros((self.d,), np.float32)
        return p

    def apply_fp(self, p: dict, x: torch.Tensor, calib=None,
                 scope: str = "") -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.kind == "layer":
            xf = xf - torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps) * p["g"]
        if self.use_bias:
            y = y + p["b"]
        y = y.to(x.dtype)
        if calib is not None:
            calib.observe(f"{scope}{self.name}", y)
        return y

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
        if self.use_bias:
            b = np.asarray(p_np.get("b", np.zeros(self.d)), np.float64)
            tables["b_q"] = np.round(b / eps_y).astype(np.int32)
        return tables, eps_y, 0

    def apply_id(self, t: dict, s: torch.Tensor) -> torch.Tensor:
        """s int8 (..., d), zp=0 -> int8 (..., d), zp=0."""
        s32 = s.to(torch.int32)
        base_shift = 0
        if self.kind == "layer":
            c_shift, base_shift = _center_shifts(self.d)
            ssum = s32.sum(dim=-1, keepdim=True, dtype=torch.int32)
            c = s32 * self.d - ssum
            cq = torch.bitwise_right_shift(c, c_shift)
            ss = (cq * cq).sum(dim=-1, keepdim=True, dtype=torch.int32)
            base = torch.bitwise_right_shift(cq, base_shift)
        else:
            ss = (s32 * s32).sum(dim=-1, keepdim=True, dtype=torch.int32)
            base = s32
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
        t1 = base * g
        t2 = torch.bitwise_right_shift(t1 * recip, NORM_BITS + 1)
        t3 = t2 * t["m"].to(torch.int32)
        shift = t["sh"].to(torch.int32) + e_r
        if base_shift:
            shift = shift - base_shift
        out = torch.bitwise_right_shift(t3, shift.clamp(0, 31))
        out = torch.bitwise_left_shift(out, (-shift).clamp(0, 31))
        out = torch.where(shift > 31, torch.zeros_like(out), out)
        if "b_q" in t:
            out = out + t["b_q"].to(torch.int32)
        return out.clamp(ACT_QMIN, ACT_QMAX).to(torch.int8)
