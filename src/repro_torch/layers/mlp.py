"""Gated feed-forward block (SwiGLU), ID path (port of
`repro.layers.mlp.QMLP`, gated: `deploy` and `apply_id`).

    s_x --wg GEMM + g_tab.rqt epilogue--> int8 --SiLU LUT--> s_g (asym)
        --wu GEMM + u_rqt epilogue-----> s_u (sym)
    prod = (s_g - zp_g) * s_u            int32, exact
        --requant h_rqt--> s_h --wd GEMM--> int32 (the block's Add)

The LUT, the product and h_rqt are one launch (`requant_gate`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.requant_kernel import requant_gate
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import ActKind, DeployCtx
from repro_torch.layers.linear import QLinear


@dataclasses.dataclass(frozen=True)
class QMLP:
    d_model: int
    d_ff: int
    act: ActKind = ActKind.SILU
    gated: bool = True
    name: str = "mlp"

    def __post_init__(self):
        if not self.gated:
            raise NotImplementedError(
                "only the gated MLP is in the dense serving slice")

    def _sub(self):
        return {
            "wu": QLinear(self.d_model, self.d_ff),
            "wd": QLinear(self.d_ff, self.d_model),
            "wg": QLinear(self.d_model, self.d_ff),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        return {n: lay.init_np(rng) for n, lay in self._sub().items()}

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float, zp_x: int
    ) -> Tuple[dict, np.ndarray]:
        subs = self._sub()
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
        s_pre = subs["wg"].apply_id(t["wg"], s_x, t["g_tab"]["rqt"])
        s_u = subs["wu"].apply_id(t["wu"], s_x, t["u_rqt"])
        s_h = requant_gate(s_pre, s_u, t["g_tab"]["lut"], t["zp_g"],
                           t["h_rqt"])
        return subs["wd"].apply_id(t["wd"], s_h)
