"""Quantizable Linear, ID path (port of `repro.layers.linear.QLinear`:
`deploy` and `apply_id`).

`apply_id` runs the int8 GEMM kernel (kernels/int8_matmul.py).  With
no requant tree it returns the int32 accumulator `x @ w_q + b_q`, as
the reference does; with the consuming site's requant tree it returns
that site's int8 image, ``apply_rqt(QLinear.apply_id(x), rqt)`` fused
into the GEMM epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.int8_matmul import int8_matmul


@dataclasses.dataclass(frozen=True)
class QLinear:
    d_in: int
    d_out: int
    use_bias: bool = False
    n_bits_w: int = 8
    init_scale: float = 1.0
    # per-out-channel weight quanta; the LM head is per-tensor (False)
    per_channel: bool = True

    def init_np(self, rng: np.random.Generator) -> dict:
        """Float params with the reference's shapes and scales
        (normal * init_scale / sqrt(d_in), zero bias)."""
        std = self.init_scale / np.sqrt(self.d_in)
        w = rng.standard_normal((self.d_in, self.d_out), dtype=np.float32)
        p = {"w": w * np.float32(std)}
        if self.use_bias:
            p["b"] = np.zeros((self.d_out,), np.float32)
        return p

    def deploy(self, p_np: dict, eps_x: float, zp_x: int) -> Tuple[
        dict, np.ndarray
    ]:
        """-> (int params {w_q, b_q}, eps_acc per out-channel)."""
        w = np.asarray(p_np["w"], np.float64)
        if self.per_channel:
            beta = np.maximum(np.max(np.abs(w), axis=0), 1e-8)
        else:
            beta = np.broadcast_to(
                np.maximum(np.max(np.abs(w)), 1e-8), (self.d_out,)).copy()
        eps_w = 2.0 * beta / (2 ** self.n_bits_w - 1)
        q_w = np.clip(
            np.floor(w / eps_w[None, :]),
            -(2 ** (self.n_bits_w - 1)),
            2 ** (self.n_bits_w - 1) - 1,
        ).astype(np.int8)
        eps_acc = eps_w * float(eps_x)
        colsum = q_w.astype(np.int64).sum(axis=0)
        b_eff = -int(zp_x) * colsum
        if self.use_bias:
            b_eff = b_eff + np.round(
                np.asarray(p_np["b"], np.float64) / eps_acc
            ).astype(np.int64)
        if np.any(np.abs(b_eff) >= 2 ** 31):
            raise ValueError("integer bias overflows int32")
        return {"w_q": q_w, "b_q": b_eff.astype(np.int32)}, eps_acc

    def acc_bound(self) -> float:
        worst = float(self.d_in) * 127.0 * 127.0
        return min(worst, 2.0 ** 30)

    def apply_id(self, ip: dict, s_x: torch.Tensor,
                 rqt: Optional[dict] = None) -> torch.Tensor:
        """s_x (..., d_in) int8 -> (..., d_out) int32 accumulator, or
        the int8 image of ``rqt`` applied to it."""
        lead = s_x.shape[:-1]
        x2 = s_x.reshape(-1, self.d_in)
        out = int8_matmul(x2, ip["w_q"], ip["b_q"], rqt)
        return out.reshape(*lead, self.d_out)
