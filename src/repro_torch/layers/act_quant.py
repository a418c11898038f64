"""The Quantization/Activation operator, ID path (port of
`repro.layers.act_quant.QAct`: `deploy` and `apply_id` for every kind).

  IDENTITY, RELU  a pure requantization (Eq. 11); ReLU's output clip
                  floor sits at the zero level.
  RELU2           requant into an int8 mid space (zp = ACT_QMIN, the
                  square root of the range), the exact integer square of
                  the image s - ACT_QMIN (at most 255^2), then a second
                  requant (`rqt2`).
  SILU, GELU      requant into a symmetric pre-activation int8 space,
                  then a 256-entry LUT.

On the dense path the first requant runs fused into the producing
GEMM's epilogue (`QLinear.apply_id(..., rqt)`); what follows it (the
LUT, or the square and `rqt2`) is one launch of the requant kernel's
act form (`requant_act`), or part of the gated MLP's `requant_gate`.
`apply_id` here is the unfused form.

The float forwards, as the reference's: `apply_fp` (the activation,
observing its output, and for SiLU / GELU its input, the LUT's space),
`apply_fq` (PACT after the activation: `pact_act` on [0, beta) for the
ReLU kinds, `pact_act_asymm` on [alpha, beta) otherwise, the clips from
`init_qstate`), `apply_qd` (Eq. 10's floor on the frozen `eps_y` and
`alpha_y` of `qd_state`) and `apply`, which picks one by
representation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.intmath import build_lut
from repro_torch.core.pact import pact_act, pact_act_asymm
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import requant, requant_act
from repro_torch.layers.common import (
    ACT_QMAX, ACT_QMIN, ActKind, DeployCtx, act_fn, act_fn_np,
)


@dataclasses.dataclass(frozen=True)
class QAct:
    kind: ActKind = ActKind.IDENTITY
    n_bits: int = 8
    name: str = "act"
    sym: bool = False
    range_scale: float = 1.0

    # -- FQ quant state -----------------------------------------------------
    def init_qstate(self, device="cuda") -> dict:
        """The learnable PACT clips: beta 6 (the ReLU kinds), or alpha
        -6 and beta 6, float32 0-d tensors."""
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        if self.kind.zero_lo:
            return {"beta": f32(6.0)}
        return {"alpha": f32(-6.0), "beta": f32(6.0)}

    # -- float paths -------------------------------------------------------
    def apply_fp(self, x: torch.Tensor, calib=None,
                 scope: str = "") -> torch.Tensor:
        y = act_fn(self.kind, x)
        if calib is not None:
            if self.kind in (ActKind.SILU, ActKind.GELU):
                calib.observe(f"{scope}{self.name}.pre", x)  # the LUT's in
            calib.observe(f"{scope}{self.name}", y)
        return y

    def apply_fq(self, qs: dict, x: torch.Tensor) -> torch.Tensor:
        y = act_fn(self.kind, x)
        if self.kind.zero_lo:
            return pact_act(y, qs["beta"], self.n_bits)
        return pact_act_asymm(y, qs["alpha"], qs["beta"], self.n_bits)

    def apply_qd(self, dstate: dict, x: torch.Tensor) -> torch.Tensor:
        """QuantizedDeployable: Eq. 10, alpha + clip(floor((y - alpha) /
        eps), 0, 2^Q - 1) eps on the frozen float32 `eps_y` / `alpha_y`
        (which lift a bfloat16 y to float32, as the reference's numpy
        scalars do)."""
        y = act_fn(self.kind, x)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        eps = torch.as_tensor(dstate["eps_y"], dtype=torch.float32,
                              device=y.device)
        alpha = torch.as_tensor(dstate["alpha_y"], dtype=torch.float32,
                                device=y.device)
        q = torch.clamp(torch.floor((y - alpha) / eps), 0.0,
                        float(2 ** self.n_bits - 1))
        return alpha + q * eps

    def qd_state(self, ctx: DeployCtx, scope: str) -> dict:
        """The frozen quantum and offset `apply_qd` reads, from the
        calibrated range (numpy float32, as the reference's)."""
        full = f"{scope}{self.name}"
        if self.kind.zero_lo:
            lo, hi = 0.0, ctx.range(full, "act")[1]
        else:
            asym = self.kind in (ActKind.SILU, ActKind.GELU)
            lo, hi = ctx.range(full, "act_asym" if asym else "resid")
        eps = (max(hi, lo + 1e-6) - lo) / (2 ** self.n_bits - 1)
        return {"eps_y": np.float32(eps), "alpha_y": np.float32(lo)}

    def apply(self, state, x: torch.Tensor, rep: Rep, *, calib=None,
              scope: str = "") -> torch.Tensor:
        """By representation: ID the integer path on its tables, FQ on
        the clips, QD on the frozen state, FP the plain activation."""
        if rep is Rep.ID:
            return self.apply_id(state, x)
        if rep is Rep.FQ:
            return self.apply_fq(state, x)
        if rep is Rep.QD:
            return self.apply_qd(state, x)
        return self.apply_fp(x, calib=calib, scope=scope)

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
        zero_lo = self.kind.zero_lo
        if zero_lo or self.kind is ActKind.IDENTITY:
            lo, hi = ctx.range(full, "act" if zero_lo else "resid")
            lo, hi = lo * self.range_scale, hi * self.range_scale
            if zero_lo:
                lo = 0.0
            sym = self.sym and not zero_lo
            if sym:
                amax = max(abs(lo), abs(hi), 1e-6)
                lo, hi = -amax, amax
            hi = max(hi, lo + 1e-6)
            eps_y = (hi - lo) / (2 ** self.n_bits - 1)
            zp = 0 if sym else ACT_QMIN - int(round(lo / eps_y))
            if self.kind is not ActKind.RELU2:
                rqt = make_rqt(
                    eps_in, eps_y, zp_out=zp, qmin=ACT_QMIN, qmax=ACT_QMAX,
                    requant_factor=ctx.factor, acc_bound=acc_bound,
                )
                return {"rqt": rqt}, eps_y, zp
            eps_mid = np.sqrt(hi) / (2 ** self.n_bits - 1)
            rqt1 = make_rqt(
                eps_in, eps_mid, zp_out=ACT_QMIN, qmin=ACT_QMIN,
                qmax=ACT_QMAX, requant_factor=ctx.factor,
                acc_bound=acc_bound,
            )
            rqt2 = make_rqt(
                eps_mid * eps_mid, eps_y, zp_out=zp, qmin=ACT_QMIN,
                qmax=ACT_QMAX, requant_factor=ctx.factor,
                acc_bound=float(255 ** 2),
            )
            return {"rqt": rqt1, "rqt2": rqt2}, eps_y, zp
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

    def apply_id(self, tables: dict, acc: torch.Tensor) -> torch.Tensor:
        s = requant(acc.to(torch.int32).contiguous(), tables["rqt"])
        if self.kind in (ActKind.IDENTITY, ActKind.RELU):
            return s
        return requant_act(s, tables)
