"""Dense transformer block, ID path (port of
`repro.models.blocks.DenseBlock`: `deploy` and `apply_id`).

norm1 -> attention -> add1 -> norm2 -> gated MLP -> add2, with the
residual stream a symmetric int8 image between blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.layers.add import QAdd
from repro_torch.layers.attention import QAttention
from repro_torch.layers.common import ActKind, DeployCtx
from repro_torch.layers.mlp import QMLP
from repro_torch.layers.norms import QNorm


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    act: ActKind = ActKind.SILU
    gated: bool = True
    norm: str = "rms"
    norm_bias: bool = False
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    max_seq: int = 4096

    def _subs(self):
        return {
            "norm1": QNorm(self.d_model, kind=self.norm,
                           use_bias=self.norm_bias, name="norm1"),
            "attn": QAttention(
                self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                rope_base=self.rope_base, rope_fraction=self.rope_fraction,
                max_seq=self.max_seq),
            "add1": QAdd(name="add1"),
            "norm2": QNorm(self.d_model, kind=self.norm,
                           use_bias=self.norm_bias, name="norm2"),
            "mlp": QMLP(self.d_model, self.d_ff, act=self.act,
                        gated=self.gated),
            "add2": QAdd(name="add2"),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        subs = self._subs()
        return {
            "norm1": subs["norm1"].init_np(),
            "attn": subs["attn"].init_np(rng),
            "norm2": subs["norm2"].init_np(),
            "mlp": subs["mlp"].init_np(rng),
        }

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_in: float
    ) -> Tuple[dict, float]:
        subs = self._subs()
        t: dict = {}
        t["norm1"], eps_n1, _ = subs["norm1"].deploy(
            ctx, scope + "n1.", p_np["norm1"], eps_in)
        t["attn"], eps_attn_acc = subs["attn"].deploy(
            ctx, scope, p_np["attn"], eps_n1, 0)
        t["add1"], eps_r1, _ = subs["add1"].deploy(
            ctx, scope, eps_in, 0, eps_attn_acc, 0)
        t["norm2"], eps_n2, _ = subs["norm2"].deploy(
            ctx, scope + "n2.", p_np["norm2"], eps_r1)
        t["mlp"], eps_m_acc = subs["mlp"].deploy(
            ctx, scope, p_np["mlp"], eps_n2, 0)
        t["add2"], eps_r2, _ = subs["add2"].deploy(
            ctx, scope, eps_r1, 0, eps_m_acc, 0)
        return t, eps_r2

    def apply_id(self, t: dict, s_x: torch.Tensor, cache: dict,
                 pos: torch.Tensor) -> torch.Tensor:
        """s_x (B, S, d) int8 -> (B, S, d) int8; writes this layer's
        K/V columns into `cache` in place."""
        subs = self._subs()
        h = subs["norm1"].apply_id(t["norm1"], s_x)
        a_acc = subs["attn"].apply_id(t["attn"], h, cache, pos)
        s_r = subs["add1"].apply_id(t["add1"], s_x, a_acc)
        h = subs["norm2"].apply_id(t["norm2"], s_r)
        m_acc = subs["mlp"].apply_id(t["mlp"], h)
        return subs["add2"].apply_id(t["add2"], s_r, m_acc)
