"""Quantizable Linear (port of `repro.layers.linear.QLinear`: the
float forwards `apply_fp` and `apply_fq`, `deploy`, `apply_id`, and
`harden_weights_np`).

`apply_fp` is a plain matmul in the input's dtype (float32 in
calibration, bfloat16 in training: the float32 weight is cast to it,
`w.astype(x.dtype)` in the reference), as the reference's is an XLA
dot outside any kernel; `apply_fq` is the same product over the
PACT-restricted weights (`core.pact`, whose straight-through backward
autograd follows), and `apply(p, x, rep)` picks the path by
representation as the reference's does (QD runs `apply_fp` on weights
`harden_weights_np` has put on the grid).

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

from repro_torch.core.pact import default_weight_beta, pact_weight
from repro_torch.core.rep import Rep
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.layers.common import (
    float_matmul, normal_np, row_spans, run_blocks,
)


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
        (normal * init_scale / sqrt(d_in), zero bias; `normal_np`)."""
        std = self.init_scale / np.sqrt(self.d_in)
        p = {"w": normal_np(rng, (self.d_in, self.d_out), std)}
        if self.use_bias:
            p["b"] = np.zeros((self.d_out,), np.float32)
        return p

    def apply_fp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = float_matmul(x, p["w"].to(x.dtype))
        if self.use_bias:
            y = y + p["b"].to(x.dtype)
        return y

    def apply_fq(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        beta_w = default_weight_beta(p["w"], channel_axis=-1)
        w_hat = pact_weight(p["w"], beta_w, self.n_bits_w, -1)
        y = float_matmul(x, w_hat.to(x.dtype))
        if self.use_bias:
            y = y + p["b"].to(x.dtype)
        return y

    def apply(self, p: dict, x: torch.Tensor, rep: Rep) -> torch.Tensor:
        if rep is Rep.ID:
            return self.apply_id(p, x)
        if rep is Rep.FQ:
            return self.apply_fq(p, x)
        return self.apply_fp(p, x)  # FP and QD (weights pre-hardened)

    def deploy(self, p_np: dict, eps_x: float, zp_x: int) -> Tuple[
        dict, np.ndarray
    ]:
        """-> (int params {w_q, b_q}, eps_acc per out-channel).

        The reference's float64 arithmetic, taken over blocks of rows
        (`row_spans`, `run_blocks`), so that the host holds a few
        blocks' float64 images at a time and not the whole matrix's
        (10.9 GB at nemotron_4_340b's up and down), and the blocks run
        in parallel: every step is elementwise, or a max or an integer
        sum over rows, so the blocks give the same bits."""
        w = np.asarray(p_np["w"])
        spans = row_spans(self.d_in, self.d_out)
        lim = 2 ** (self.n_bits_w - 1)
        # |w| and its maximum are exact in w's own dtype
        amax = np.max(run_blocks(
            lambda r0, r1: np.max(np.abs(w[r0:r1]), axis=0), spans),
            axis=0).astype(np.float64)
        if self.per_channel:
            beta = np.maximum(amax, 1e-8)
        else:
            beta = np.broadcast_to(
                np.maximum(np.max(amax), 1e-8), (self.d_out,)).copy()
        eps_w = 2.0 * beta / (2 ** self.n_bits_w - 1)
        q_w = np.empty((self.d_in, self.d_out), np.int8)

        def quantize(r0, r1):
            q = np.floor(np.asarray(w[r0:r1], np.float64) / eps_w[None, :])
            np.clip(q, -lim, lim - 1, out=q)
            q_w[r0:r1] = q
            return q.sum(axis=0).astype(np.int64)

        colsum = np.sum(run_blocks(quantize, spans), axis=0,
                        dtype=np.int64)
        eps_acc = eps_w * float(eps_x)
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


def harden_weights_np(p_np: dict, n_bits: int = 8) -> dict:
    """FQ -> QD: replace w by its quantized version (net.harden_weights()),
    float64 on the host as the reference's."""
    w = np.asarray(p_np["w"], np.float64)
    beta = np.maximum(np.max(np.abs(w), axis=0), 1e-8)
    eps_w = 2.0 * beta / (2 ** n_bits - 1)
    q = np.clip(np.floor(w / eps_w[None, :]), -(2 ** (n_bits - 1)),
                2 ** (n_bits - 1) - 1)
    out = dict(p_np)
    out["w"] = (q * eps_w[None, :]).astype(np.float32)
    return out
