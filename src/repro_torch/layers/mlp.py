"""Feed-forward blocks, gated (SwiGLU) and plain (GELU, squared ReLU)
(port of `repro.layers.mlp.QMLP`: the float forward `apply_float` at FP
and FQ, `init_qstate`, `deploy` and `apply_id`).

Gated.  Float: h = act(x @ wg) * (x @ wu), out = h @ wd, observing the
gate's input and output, up and h.  At FQ the products run on
PACT-restricted weights and act(.) goes through the learnable clip of
`init_qstate` (`pact_act` where the activation is clipped at 0 from
below, `pact_act_asymm` otherwise), as the reference's `maybe_fq`.
Integer:

    s_x --wg GEMM + g_tab.rqt epilogue--> int8 --SiLU LUT--> s_g (asym)
        --wu GEMM + u_rqt epilogue-----> s_u (sym)
    prod = (s_g - zp_g) * s_u            int32, exact
        --requant h_rqt--> s_h --wd GEMM--> int32 (the block's Add)

The LUT, the product and h_rqt are one launch (`requant_gate`).

Ungated.  Float: h = act(x @ wu), out = h @ wd, observing the
activation's input and output, then h.  Integer:

    s_x --wu GEMM + u_tab.rqt epilogue--> int8
        --LUT (GELU), or rqt2 of the exact square (ReLU^2)--> s_h (asym)
        --wd GEMM--> int32 (the block's Add)

The activation is one launch (`requant_act`; ReLU and IDENTITY need
none: their requant is the epilogue).  wd deploys with s_h's zero point, folded
into its int32 bias as -zp_h * colsum; where that and the products
pass 2^31 (K 73728) the accumulator wraps in int32 as the reference's
does, on the card and on the CPU alike.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.pact import pact_act, pact_act_asymm
from repro_torch.core.rep import Rep
from repro_torch.kernels.requant_kernel import requant_act, requant_gate
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import ActKind, DeployCtx, act_fn
from repro_torch.layers.linear import QLinear


@dataclasses.dataclass(frozen=True)
class QMLP:
    d_model: int
    d_ff: int
    act: ActKind = ActKind.SILU
    gated: bool = True
    name: str = "mlp"

    def _sub(self):
        subs = {
            "wu": QLinear(self.d_model, self.d_ff),
            "wd": QLinear(self.d_ff, self.d_model),
        }
        if self.gated:
            subs["wg"] = QLinear(self.d_model, self.d_ff)
        return subs

    def init_np(self, rng: np.random.Generator) -> dict:
        return {n: lay.init_np(rng) for n, lay in self._sub().items()}

    def init_qstate(self, device="cuda") -> dict:
        """The FQ learnable clips of the nonlinear activation (paper
        §2.2), float32 scalars: beta 6 (and alpha -1 where the
        activation is not clipped at 0)."""
        if self.act.zero_lo:
            return {"beta": torch.tensor(6.0, device=device)}
        return {"alpha": torch.tensor(-1.0, device=device),
                "beta": torch.tensor(6.0, device=device)}

    def _maybe_fq(self, a: torch.Tensor, rep: Rep, qs) -> torch.Tensor:
        if rep is Rep.FQ and qs is not None:
            if self.act.zero_lo:
                return pact_act(a, qs["beta"], 8)
            return pact_act_asymm(a, qs["alpha"], qs["beta"], 8)
        return a

    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", *, rep: Rep = Rep.FP,
                    qs=None) -> torch.Tensor:
        subs = self._sub()
        u = subs["wu"].apply(p["wu"], x, rep)
        if not self.gated:
            h = self._maybe_fq(act_fn(self.act, u), rep, qs)
            if calib is not None:
                calib.observe(f"{scope}{self.name}.act.pre", u)
                calib.observe(f"{scope}{self.name}.act", h)
                calib.observe(f"{scope}{self.name}.h", h)
            return subs["wd"].apply(p["wd"], h, rep)
        g_pre = subs["wg"].apply(p["wg"], x, rep)
        g = self._maybe_fq(act_fn(self.act, g_pre), rep, qs)
        h = g * u
        if calib is not None:
            # the reference writes wg's product out again for these
            # two (the same value at FP, where calibration runs); here
            # it is computed once
            calib.observe(f"{scope}{self.name}.gate.pre", g_pre)
            calib.observe(f"{scope}{self.name}.gate", g)
            calib.observe(f"{scope}{self.name}.up", u)
            calib.observe(f"{scope}{self.name}.h", h)
        return subs["wd"].apply(p["wd"], h, rep)

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float, zp_x: int
    ) -> Tuple[dict, np.ndarray]:
        subs = self._sub()
        if not self.gated:
            act_u = QAct(self.act, name=f"{self.name}.act")
            ip_u, eps_acc_u = subs["wu"].deploy(p_np["wu"], eps_x, zp_x)
            tu, eps_h, zp_h = act_u.deploy(
                ctx, scope, eps_acc_u, 0, subs["wu"].acc_bound())
            ip_d, eps_acc_d = subs["wd"].deploy(p_np["wd"], eps_h, zp_h)
            return {"wu": ip_u, "u_tab": tu, "wd": ip_d}, eps_acc_d
        act_g = QAct(self.act, name=f"{self.name}.gate")
        ip_g, eps_acc_g = subs["wg"].deploy(p_np["wg"], eps_x, zp_x)
        tg, eps_g, zp_g = act_g.deploy(
            ctx, scope, eps_acc_g, 0, subs["wg"].acc_bound())
        act_u = QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.up")
        ip_u, eps_acc_u = subs["wu"].deploy(p_np["wu"], eps_x, zp_x)
        tu, eps_u, _ = act_u.deploy(
            ctx, scope, eps_acc_u, 0, subs["wu"].acc_bound())
        act_h = QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.h")
        th, eps_h, _ = act_h.deploy(ctx, scope, eps_g * eps_u, 0,
                                    acc_bound=float(256 * 128))
        ip_d, eps_acc_d = subs["wd"].deploy(p_np["wd"], eps_h, 0)
        t = {
            "wg": ip_g, "g_tab": tg, "wu": ip_u, "u_rqt": tu["rqt"],
            "h_rqt": th["rqt"], "wd": ip_d, "zp_g": np.int32(zp_g),
        }
        return t, eps_acc_d

    def apply_id(self, t: dict, s_x: torch.Tensor) -> torch.Tensor:
        subs = self._sub()
        if not self.gated:
            s_h = subs["wu"].apply_id(t["wu"], s_x, t["u_tab"]["rqt"])
            if self.act not in (ActKind.IDENTITY, ActKind.RELU):
                s_h = requant_act(s_h, t["u_tab"])
            return subs["wd"].apply_id(t["wd"], s_h)
        s_pre = subs["wg"].apply_id(t["wg"], s_x, t["g_tab"]["rqt"])
        s_u = subs["wu"].apply_id(t["wu"], s_x, t["u_rqt"])
        s_h = requant_gate(s_pre, s_u, t["g_tab"]["lut"], t["zp_g"],
                           t["h_rqt"])
        return subs["wd"].apply_id(t["wd"], s_h)
