"""Calibration: choose activation clipping ranges from data (port of
`repro.core.calibrate.Calibrator`; the paper's §2.2: 'beta can be set
to the maximum value of y in the FullPrecision stage').

A `Calibrator` accumulates a running min/max per named observation
point while the model runs its float (FullPrecision) forward
(`models.lm.DecoderLM.calibrate`, or layer by layer in
`launch.serve.deploy_model`), then hands deployment the (lo, hi)
ranges its integer tables are built from.  `observe` takes a torch
tensor on any device and reads its min and max into Python floats (one
copy to the host on the card).  A state recorded elsewhere, e.g. by
the reference's `Calibrator.state_dict()`, loads through `from_state`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class Calibrator:
    lo: Dict[str, float] = dataclasses.field(default_factory=dict)
    hi: Dict[str, float] = dataclasses.field(default_factory=dict)
    momentum: float = 1.0  # 1.0 = pure running max (NEMO default behaviour)

    def observe(self, name: str, x: torch.Tensor) -> None:
        x_lo, x_hi = (float(v) for v in torch.stack(
            torch.aminmax(x.detach())).cpu())
        if name not in self.hi:
            self.lo[name], self.hi[name] = x_lo, x_hi
        elif self.momentum >= 1.0:
            self.lo[name] = min(self.lo[name], x_lo)
            self.hi[name] = max(self.hi[name], x_hi)
        else:
            m = self.momentum
            self.lo[name] = (
                (1 - m) * self.lo[name] + m * min(self.lo[name], x_lo))
            self.hi[name] = (
                (1 - m) * self.hi[name] + m * max(self.hi[name], x_hi))

    def range(
        self,
        name: str,
        *,
        default: Tuple[float, float] = (0.0, 6.0),
        margin: float = 0.0,
    ) -> Tuple[float, float]:
        if name not in self.hi:
            return default
        lo, hi = self.lo[name], self.hi[name]
        span = max(hi - lo, 1e-6)
        lo -= margin * span
        hi += margin * span
        if hi <= lo + 1e-8:
            hi = lo + 1e-6
        return lo, hi

    def beta(self, name: str, *, default: float = 6.0) -> float:
        """Clip ceiling for ReLU-family activations (alpha pinned at 0)."""
        if name not in self.hi:
            return default
        return max(float(self.hi[name]), 1e-6)

    def merge(self, other: "Calibrator") -> None:
        """Combine stats from another shard/host (data-parallel
        calibration)."""
        for name in other.hi:
            if name not in self.hi:
                self.lo[name], self.hi[name] = other.lo[name], other.hi[name]
            else:
                self.lo[name] = min(self.lo[name], other.lo[name])
                self.hi[name] = max(self.hi[name], other.hi[name])

    def state_dict(self) -> dict:
        return {"lo": dict(self.lo), "hi": dict(self.hi)}

    @staticmethod
    def from_state(state: dict) -> "Calibrator":
        c = Calibrator()
        c.lo.update({k: float(v) for k, v in state["lo"].items()})
        c.hi.update({k: float(v) for k, v in state["hi"].items()})
        return c
