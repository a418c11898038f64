"""Token embedding (port of `repro.layers.embedding.QEmbed`: the
float forward, `deploy` and the ID path).

The int8 table is the first activation image (symmetric, zp = 0); the
lookup is a gather in both representations.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

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

    def deploy(self, ctx: DeployCtx, p_np: dict) -> Tuple[dict, float, int]:
        t = np.asarray(p_np["table"], np.float64)
        amax = max(float(np.max(np.abs(t))), 1e-8)
        eps = 2.0 * amax / 255.0
        q = np.clip(np.floor(t / eps), -128, 127).astype(np.int8)
        return {"table_q": q}, eps, 0

    def apply_id(self, ip: dict, tok: torch.Tensor) -> torch.Tensor:
        return ip["table_q"][tok.to(torch.int64)]
