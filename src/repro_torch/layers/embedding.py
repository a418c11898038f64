"""Token embedding (port of `repro.layers.embedding.QEmbed`: the
float forwards FP and FQ, `deploy` and the ID path).

The int8 table is the first activation image (symmetric, zp = 0); the
lookup is a gather in every representation.  At FQ the table is a
Linear's weight (a one-hot product) and goes through `pact_weight`
first, per d-channel at 8 bits.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.pact import default_weight_beta, pact_weight
from repro_torch.core.rep import Rep
from repro_torch.layers.common import DeployCtx, normal_np


@dataclasses.dataclass(frozen=True)
class QEmbed:
    vocab: int
    d: int
    name: str = "embed"

    def init_np(self, rng: np.random.Generator) -> dict:
        return {"table": normal_np(rng, (self.vocab, self.d), 0.02)}

    def apply_fp(self, p: dict, tok: torch.Tensor, calib=None,
                 scope: str = "") -> torch.Tensor:
        y = p["table"][tok.to(torch.int64)]
        if calib is not None:
            calib.observe(f"{scope}{self.name}", y)
        return y

    def apply_fq(self, p: dict, tok: torch.Tensor) -> torch.Tensor:
        beta = default_weight_beta(p["table"], channel_axis=-1)
        t_hat = pact_weight(p["table"], beta, 8, -1)
        return t_hat[tok.to(torch.int64)]

    def apply(self, p: dict, tok: torch.Tensor, rep: Rep, *, calib=None,
              scope: str = "") -> torch.Tensor:
        if rep is Rep.ID:
            return self.apply_id(p, tok)
        if rep is Rep.FQ:
            return self.apply_fq(p, tok)
        return self.apply_fp(p, tok, calib, scope)

    def deploy(self, ctx: DeployCtx, p_np: dict) -> Tuple[dict, float, int]:
        t = np.asarray(p_np["table"], np.float64)
        amax = max(float(np.max(np.abs(t))), 1e-8)
        eps = 2.0 * amax / 255.0
        q = np.clip(np.floor(t / eps), -128, 127).astype(np.int8)
        return {"table_q": q}, eps, 0

    def apply_id(self, ip: dict, tok: torch.Tensor) -> torch.Tensor:
        return ip["table_q"][tok.to(torch.int64)]
