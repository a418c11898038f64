"""Shared layer scaffolding (port of `repro.layers.common`, cut to the
dense path): activation kinds, the float activations of the
FullPrecision forward (`act_fn`) and their numpy twins for LUT
building, the deploy context, the default calibration ranges and
per-layer tree stacking.

Conventions (as in the reference): stored activation images are int8
with a per-space zero point, the residual stream and norm inputs are
symmetric (zp = 0), weights are int8 symmetric per out-channel, and
Linear accumulators are int32 with the zero-point correction folded
into a static bias.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import enum
import os
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.island import exp_f32, tanh_f32

ACT_QMIN, ACT_QMAX = -128, 127


class ActKind(enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU2 = "relu2"
    SILU = "silu"
    GELU = "gelu"

    @property
    def zero_lo(self) -> bool:
        """Activations clipped at 0 from below (ReLU, squared ReLU)."""
        return self in (ActKind.RELU, ActKind.RELU2)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def act_fn(kind: ActKind, x: torch.Tensor) -> torch.Tensor:
    """Full-precision activation of the float forward, written as the
    reference's `act_fn` is, operation for operation: on float32 its
    exp and tanh are the reference lowering's (`core.island`), so the
    result is the reference's and the same on every device; a bfloat16
    result rounds the library's float32 exp and tanh to 8 bits, where
    the two agree (no difference over 2.4e4 inputs,
    `tests/test_torch_train_moe.py`) at a fraction of the cost.  ReLU is
    a maximum with 0, whose gradient at 0 is half the incoming one, as
    jax's."""
    if kind is ActKind.IDENTITY:
        return x
    if kind is ActKind.RELU:
        return torch.maximum(x, _zero(x))
    if kind is ActKind.RELU2:
        r = torch.maximum(x, _zero(x))
        return r * r
    exact = x.dtype == torch.float32
    if kind is ActKind.SILU:
        e = exp_f32(-x) if exact else torch.exp(-x)
        return x * (1.0 / (1.0 + e))
    if kind is ActKind.GELU:
        # tanh approximation (the reference's, jax.nn.gelu approximate);
        # its constants in x's dtype, as jax's weak typing rounds them
        c = torch.tensor(float(np.sqrt(2.0 / np.pi)), dtype=x.dtype,
                         device=x.device)
        k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
        inner = c * (x + k * (x * x * x))
        return 0.5 * x * (1.0 + (tanh_f32(inner) if exact
                                 else torch.tanh(inner)))
    raise ValueError(kind)


def float_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of the float forward in the operands' dtype.  A bfloat16
    product is each output accumulated in float32 and rounded to
    bfloat16 once, as the reference's XLA dot computes it: torch's CPU
    bfloat16 matmul rounds otherwise on a few outputs in 10^5, so on
    the CPU the product runs in float32 and is cast back; on the card
    it is cuBLAS's bfloat16 product."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(torch.bfloat16)
    return torch.matmul(a, b)


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


ROW_BLOCK_ELEMENTS = 1 << 24  # elements of one host row block


def row_spans(n_rows: int, row_elements: int) -> List[Tuple[int, int]]:
    """Blocks [r0, r1) of whole rows, at most ROW_BLOCK_ELEMENTS
    elements each."""
    rows = max(1, ROW_BLOCK_ELEMENTS // max(row_elements, 1))
    return [(r0, min(r0 + rows, n_rows)) for r0 in range(0, n_rows, rows)]


def run_blocks(fn: Callable, items: List[tuple]) -> List:
    """[fn(*item) for item in items], in order, on a thread each where
    there are several (numpy releases the GIL in its array loops and
    while a generator fills an array)."""
    if len(items) == 1:
        return [fn(*items[0])]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda it: fn(*it), items))


_SHAPES = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Inside, `normal_np` draws nothing and returns a read-only
    zero-stride view of one float32 zero: an `init_np` then gives its
    tree's shapes without allocating its weights (`launch.specs`)."""
    prev = getattr(_SHAPES, "on", False)
    _SHAPES.on = True
    try:
        yield
    finally:
        _SHAPES.on = prev


def normal_np(rng: np.random.Generator, shape, scale: float) -> np.ndarray:
    """float32 standard normals times `scale`, each block of rows
    (`row_spans`) drawn from its own generator seeded from `rng`: the
    same array for the same `rng` state on any host, the blocks of a
    large matrix drawn in parallel."""
    if getattr(_SHAPES, "on", False):
        return np.broadcast_to(np.float32(0.0), tuple(shape))
    out = np.empty(shape, np.float32)
    spans = row_spans(shape[0], int(np.prod(shape[1:])))
    seeds = rng.integers(0, 2 ** 63 - 1, size=len(spans), dtype=np.int64)

    def fill(r0, r1, seed):
        np.random.default_rng(seed).standard_normal(
            out=out[r0:r1], dtype=np.float32)

    run_blocks(fill, [(r0, r1, int(sd)) for (r0, r1), sd in zip(spans,
                                                                 seeds)])
    out *= np.float32(scale)
    return out


def stack_trees(trees):
    """Stack a list of per-layer numpy trees along a new leading axis
    (the reference's layer-stacked table layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees], axis=0)
