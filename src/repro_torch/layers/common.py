"""Shared layer scaffolding (port of `repro.layers.common`, cut to the
dense serving path): activation kinds, the deploy context, the
default calibration ranges and per-layer tree stacking.

Conventions (as in the reference): stored activation images are int8
with a per-space zero point, the residual stream and norm inputs are
symmetric (zp = 0), weights are int8 symmetric per out-channel, and
Linear accumulators are int32 with the zero-point correction folded
into a static bias.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

ACT_QMIN, ACT_QMAX = -128, 127


class ActKind(enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU2 = "relu2"
    SILU = "silu"
    GELU = "gelu"


def act_fn_np(kind: ActKind, x: np.ndarray) -> np.ndarray:
    """numpy activation for transform-time LUT construction."""
    if kind is ActKind.IDENTITY:
        return x
    if kind is ActKind.RELU:
        return np.maximum(x, 0.0)
    if kind is ActKind.RELU2:
        r = np.maximum(x, 0.0)
        return r * r
    if kind is ActKind.SILU:
        return x / (1.0 + np.exp(-x))
    if kind is ActKind.GELU:
        c = np.sqrt(2.0 / np.pi)
        return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))
    raise ValueError(kind)


# Default calibration ranges per site type, used when a model is
# deployed without a calibration pass (the same placeholders the
# reference's full-size dry-run deploys with).
DEFAULT_RANGES = {
    "resid": (-8.0, 8.0),
    "norm": (-8.0, 8.0),
    "act": (0.0, 8.0),
    "act_asym": (-1.0, 8.0),
    "attn": (-8.0, 8.0),
    "logits": (-32.0, 32.0),
    "ssm": (-16.0, 16.0),
}


@dataclasses.dataclass
class DeployCtx:
    """Host-side transform state threaded through every `deploy`.

    calib:   a `core.calibrate.Calibrator` or None (DEFAULT_RANGES)
    factor:  requantization_factor (1/eta, Eq. 14)
    n_bits:  activation/weight bit width
    """

    calib: Optional[object] = None
    factor: int = 256
    n_bits: int = 8

    def range(self, name: str, kind: str = "resid"):
        if self.calib is not None and name in getattr(self.calib, "hi", {}):
            return self.calib.range(name)
        return DEFAULT_RANGES.get(kind, DEFAULT_RANGES["resid"])


def stack_trees(trees):
    """Stack a list of per-layer numpy trees along a new leading axis
    (the reference's layer-stacked table layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees], axis=0)
