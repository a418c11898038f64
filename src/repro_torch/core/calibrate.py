"""Calibration state (port of `repro.core.calibrate.Calibrator`, cut to
what deployment reads).

The port deploys either without calibration (`DEFAULT_RANGES`) or from
a calibrator state recorded by the reference (`Calibrator.state_dict()`
there, `Calibrator.from_state` here), so the port's integer tables can
equal the reference's leaf for leaf.  Observing activations
(`observe`) needs the float forward, which a later slice ports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass
class Calibrator:
    lo: Dict[str, float] = dataclasses.field(default_factory=dict)
    hi: Dict[str, float] = dataclasses.field(default_factory=dict)

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

    def state_dict(self) -> dict:
        return {"lo": dict(self.lo), "hi": dict(self.hi)}

    @staticmethod
    def from_state(state: dict) -> "Calibrator":
        c = Calibrator()
        c.lo.update({k: float(v) for k, v in state["lo"].items()})
        c.hi.update({k: float(v) for k, v in state["hi"].items()})
        return c
