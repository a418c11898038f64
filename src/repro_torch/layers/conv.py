"""2-D convolution and pooling under NEMO quantization (port of
`repro.layers.conv`; the paper's own operator set, §3.3-§3.6).  NHWC
layout; weights HWIO.

Every convolution is an im2col and a matrix product.  The columns run
over (kh, kw, cin) with cin fastest, the order of the HWIO weights
reshaped to (-1, c_out), as the reference's `deploy` reshapes them.

  * The float forwards (`apply_fp`, `apply_fq`) multiply in float32 at
    full precision (the function checks `float32_matmul_precision`, so
    that the card takes no TF32 shortcut and calibrates on the ranges the
    CPU sees).
  * The ID path (`apply_id`) multiplies the int8 columns by the int8
    weights on the int8 GEMM kernel (kernels/int8_matmul.py): int32
    accumulators plus the static bias (-zp_in * colsum), or, given the
    consuming requant tree, its int8 image fused into the GEMM's
    epilogue.  The kernel takes K in multiples of 16, so the device
    layout (`QConv2d.load`) pads K = kh * kw * cin with zero weight
    rows, and the columns with as many zero columns; the products are
    unchanged.  The deployed `w_q` stays the reference's HWIO leaf.

Any stride.  SAME padding is XLA's rule, as the reference's
`conv_general_dilated` pads: Ho = ceil(H / stride), a total pad of
max((Ho - 1) stride + k - H, 0) a spatial dim, its half (rounded down)
before and the rest after, so an even kernel or a stride > 1 may pad
one more on the high side.  The ID path fills the ring with the input's
zero point, so that the ring decodes to real 0 and the deploy's bias
correction holds; with zp 0 that is the reference's plain SAME padding.
Like the reference, it takes a nonzero zero point under SAME only at
stride 1 with an odd kernel (a symmetric ring) and raises
NotImplementedError otherwise.

BN handling offers the paper's full menu (models/cnn.py picks one):
fold (Eq. 18), integer BN (Eq. 22), thresholds (Eq. 19-20).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bn import (
    IntegerBNParams, bn_apply_float, make_bn_act_thresholds, make_integer_bn,
)
from repro_torch.core.intmath import (
    avgpool_requant_params, int_avgpool_combine,
)
from repro_torch.core.pact import default_weight_beta, pact_weight
from repro_torch.core.rep import Rep
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.layers.common import ACT_QMAX, ACT_QMIN, normal_np

K_ALIGN = 16  # the int8 GEMM kernel's K granule


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.get_float32_matmul_precision() != "highest":
        raise ValueError("the float convolution needs full float32 "
                         "matmuls (float32_matmul_precision 'highest')")
    return a @ b


@dataclasses.dataclass(frozen=True)
class QConv2d:
    c_in: int
    c_out: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    use_bias: bool = False
    n_bits_w: int = 8

    def init_np(self, rng: np.random.Generator) -> dict:
        """Float params with the reference's shapes and scales (HWIO
        normals / sqrt(fan_in), zero bias)."""
        fan_in = self.kernel * self.kernel * self.c_in
        p = {"w": normal_np(rng, (self.kernel, self.kernel, self.c_in,
                                  self.c_out), 1.0 / np.sqrt(fan_in))}
        if self.use_bias:
            p["b"] = np.zeros((self.c_out,), np.float32)
        return p

    # -- im2col ----------------------------------------------------------
    @property
    def k_cols(self) -> int:
        return self.kernel * self.kernel * self.c_in

    @property
    def k_pad(self) -> int:
        """K of the device layout: k_cols rounded up to K_ALIGN."""
        return -(-self.k_cols // K_ALIGN) * K_ALIGN

    def _pads(self, n: int) -> Tuple[int, int]:
        """(low, high) pad of a spatial dim of n under the padding."""
        if self.padding == "VALID":
            return 0, 0
        if self.padding != "SAME":
            raise ValueError(f"padding {self.padding!r}: SAME or VALID")
        total = max((-(-n // self.stride) - 1) * self.stride + self.kernel
                    - n, 0)
        return total // 2, total - total // 2

    def im2col(self, x: torch.Tensor, pad_value, k_pad: int
               ) -> Tuple[torch.Tensor, tuple]:
        """x (B, H, W, c_in) -> ((B*Ho*Wo, k_pad) columns, (B, Ho, Wo)):
        the ring filled with ``pad_value``, the windows `stride` apart,
        K in (kh, kw, cin) order, then zero columns up to k_pad."""
        (h0, h1), (w0, w1) = self._pads(x.shape[1]), self._pads(x.shape[2])
        if h0 or h1 or w0 or w1:
            x = F.pad(x, (0, 0, w0, w1, h0, h1), value=pad_value)
        B, Hp, Wp, _ = x.shape
        k, st = self.kernel, self.stride
        Ho, Wo = (Hp - k) // st + 1, (Wp - k) // st + 1
        parts = [x[:, dy:dy + (Ho - 1) * st + 1:st,
                   dx:dx + (Wo - 1) * st + 1:st, :]
                 for dy in range(k) for dx in range(k)]
        if k_pad > self.k_cols:
            parts.append(x.new_zeros((B, Ho, Wo, k_pad - self.k_cols)))
        cols = torch.cat(parts, dim=-1)
        return cols.reshape(B * Ho * Wo, k_pad), (B, Ho, Wo)

    # -- float paths -----------------------------------------------------
    def _conv_f32(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        cols, (B, Ho, Wo) = self.im2col(x, 0.0, self.k_cols)
        y = _matmul_f32(cols, w.to(x.dtype).reshape(self.k_cols, self.c_out))
        return y.reshape(B, Ho, Wo, self.c_out)

    def apply_fp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_f32(x, p["w"])
        if self.use_bias:
            y = y + p["b"]
        return y

    def apply_fq(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        beta_w = default_weight_beta(p["w"], channel_axis=-1)
        w_hat = pact_weight(p["w"], beta_w, self.n_bits_w, -1)
        y = self._conv_f32(x, w_hat)
        if self.use_bias:
            y = y + p["b"]
        return y

    # -- transform -------------------------------------------------------
    def deploy(self, p_np: dict, eps_x: float, zp_x: int) -> Tuple[
        dict, np.ndarray
    ]:
        """-> ({w_q HWIO int8, b_q int32, zp_in}, eps_acc per channel),
        the reference's float64 arithmetic."""
        w = np.asarray(p_np["w"], np.float64)
        beta = np.maximum(np.abs(w).reshape(-1, self.c_out).max(axis=0), 1e-8)
        eps_w = 2.0 * beta / (2 ** self.n_bits_w - 1)
        q_w = np.clip(
            np.floor(w / eps_w),
            -(2 ** (self.n_bits_w - 1)),
            2 ** (self.n_bits_w - 1) - 1,
        ).astype(np.int8)
        eps_acc = eps_w * float(eps_x)
        colsum = q_w.astype(np.int64).reshape(-1, self.c_out).sum(axis=0)
        b_eff = -int(zp_x) * colsum
        if self.use_bias:
            b_eff = b_eff + np.round(
                np.asarray(p_np["b"], np.float64) / eps_acc).astype(np.int64)
        # zp kept for SAME padding: the ring holds the zero point
        return {"w_q": q_w, "b_q": b_eff.astype(np.int32),
                "zp_in": np.int32(zp_x)}, eps_acc

    def acc_bound(self) -> float:
        return min(
            self.kernel * self.kernel * self.c_in * 127.0 * 127.0, 2.0 ** 30
        )

    def load(self, ip_np: dict, device="cuda") -> dict:
        """Deployed tables -> the device form `apply_id` reads: w_q as
        (k_pad, c_out) int8 stored transposed ((c_out, k_pad) contiguous,
        the GEMM kernel's layout), zero rows past k_cols; b_q int32;
        zp_in a Python int (static, as the reference reads it)."""
        w = np.asarray(ip_np["w_q"], np.int8).reshape(self.k_cols,
                                                      self.c_out)
        wt = np.zeros((self.c_out, self.k_pad), np.int8)
        wt[:, :self.k_cols] = w.T
        return {
            "w_q": torch.from_numpy(wt).to(device).t(),
            "b_q": torch.from_numpy(
                np.ascontiguousarray(ip_np["b_q"], np.int32)).to(device),
            "zp_in": int(np.asarray(ip_np["zp_in"])),
        }

    # -- integer path ----------------------------------------------------
    def apply_id(self, ip: dict, s_x: torch.Tensor,
                 rqt: Optional[dict] = None) -> torch.Tensor:
        """s_x (B, H, W, c_in) int8 -> (B, Ho, Wo, c_out) int32
        accumulator (conv + b_q), or its int8 image under ``rqt``;
        ``ip`` from `load`.  SAME with a nonzero zero point needs stride
        1 and an odd kernel, as in the reference."""
        if self.padding == "SAME" and ip["zp_in"] != 0 and (
                self.stride != 1 or self.kernel % 2 != 1):
            raise NotImplementedError("zp-pad needs stride 1, odd k")
        cols, (B, Ho, Wo) = self.im2col(s_x, ip["zp_in"],
                                        ip["w_q"].shape[0])
        out = int8_matmul(cols, ip["w_q"], ip["b_q"], rqt)
        return out.reshape(B, Ho, Wo, self.c_out)

    def apply(self, p: dict, x: torch.Tensor, rep: Rep) -> torch.Tensor:
        if rep is Rep.ID:
            return self.apply_id(p, x)
        if rep is Rep.FQ:
            return self.apply_fq(p, x)
        return self.apply_fp(p, x)


@dataclasses.dataclass(frozen=True)
class QBatchNorm2d:
    """BatchNorm with the paper's three deployment strategies."""

    c: int
    eps: float = 1e-5

    def init_np(self) -> dict:
        return {
            "gamma": np.ones((self.c,), np.float32),
            "beta": np.zeros((self.c,), np.float32),
            "mu": np.zeros((self.c,), np.float32),
            "sigma": np.ones((self.c,), np.float32),
        }

    def apply_fp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return bn_apply_float(x, p["gamma"], p["beta"], p["mu"], p["sigma"])

    def make_integer(self, p_np, eps_phi, acc_bound) -> IntegerBNParams:
        return make_integer_bn(
            p_np["gamma"], p_np["beta"], p_np["mu"], p_np["sigma"], eps_phi,
            acc_bound=acc_bound,
        )

    def make_thresholds(self, p_np, eps_phi, eps_y, n_levels,
                        rounded: bool = False):
        return make_bn_act_thresholds(
            p_np["gamma"], p_np["beta"], p_np["mu"], p_np["sigma"], eps_phi,
            eps_y, n_levels, rounded=rounded,
        )


def _windows(x: torch.Tensor, k: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // k, k, W // k, k, C)


@dataclasses.dataclass(frozen=True)
class QAvgPool2d:
    """Integer average pooling (Eq. 25)."""

    k: int = 2

    def apply_fp(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(_windows(x, self.k), dim=(2, 4))

    def apply_id(self, s_x: torch.Tensor, d: int = 15) -> torch.Tensor:
        """int8 in, int8 out: the int32 window sum, (m * sum + 2^(d-1))
        >> d, clipped to int8."""
        m, dd = avgpool_requant_params(self.k * self.k, d)
        acc = _windows(s_x.to(torch.int32), self.k).sum(
            dim=(2, 4), dtype=torch.int32)
        out = int_avgpool_combine(acc, m, dd)
        return torch.clamp(out, ACT_QMIN, ACT_QMAX).to(torch.int8)

    def apply(self, x: torch.Tensor, rep: Rep) -> torch.Tensor:
        return self.apply_id(x) if rep is Rep.ID else self.apply_fp(x)


@dataclasses.dataclass(frozen=True)
class QMaxPool2d:
    """Max pooling, untouched by quantization (paper §3.6: Q preserves
    relative ordering), so FP and ID share one implementation."""

    k: int = 2

    def apply(self, x: torch.Tensor, rep=None) -> torch.Tensor:
        return torch.amax(_windows(x, self.k), dim=(2, 4))
