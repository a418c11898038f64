"""Quantized spaces, quanta and integer images (port of
`repro.core.quantum`; paper Def. 2.1 / 2.2).

A quantized tensor is ``t_hat = alpha_t + eps_t * Q_t(t)`` with quantum
``eps_t`` (scalar or per channel), offset ``alpha_t`` and integer image
``Q_t(t)`` in a finite space ``Z_t``.  Images are stored in signed
dtypes; an unsigned canonical image ``[0, 2^Q - 1]`` is stored shifted
by a zero point, so that

    real_value = eps * (stored - zp)          # NEMO's alpha = -eps * zp

Weights are symmetric (zp 0) with per-output-channel quanta.

`quantize_affine`, `dequantize` and `fake_quantize` are the runtime
forms (torch, any device); the rest is transform-time math on the host
in float64 numpy, the reference's operation for operation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A quantized space Z_t (Def. 2.1): 2**n_bits levels, signed or
    not; `dtype` is the narrowest signed torch dtype holding the stored
    image, `np_dtype` its numpy twin."""

    n_bits: int = 8
    signed: bool = True

    def __post_init__(self):
        if not (2 <= self.n_bits <= 32):
            raise ValueError(f"n_bits must be in [2, 32], got {self.n_bits}")

    @property
    def qmin(self) -> int:
        return -(1 << (self.n_bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return ((1 << (self.n_bits - 1)) - 1 if self.signed
                else (1 << self.n_bits) - 1)

    @property
    def levels(self) -> int:
        return 1 << self.n_bits

    @property
    def zero_point(self) -> int:
        """The shift that stores an unsigned space in the signed dtype:
        stored = image + qmin(signed)."""
        return 0 if self.signed else -(1 << (self.n_bits - 1))

    @property
    def dtype(self) -> torch.dtype:
        if self.n_bits <= 8:
            return torch.int8
        if self.n_bits <= 16:
            return torch.int16
        return torch.int32

    @property
    def np_dtype(self):
        return {torch.int8: np.int8, torch.int16: np.int16,
                torch.int32: np.int32}[self.dtype]

    @property
    def store_min(self) -> int:
        return self.qmin + self.zero_point

    @property
    def store_max(self) -> int:
        return self.qmax + self.zero_point


INT8 = QuantSpec(8, signed=True)
UINT8 = QuantSpec(8, signed=False)  # stored int8 with zp -128
INT16 = QuantSpec(16, signed=True)
INT32 = QuantSpec(32, signed=True)


@dataclasses.dataclass(frozen=True)
class QMeta:
    """(eps, zp, spec): how to read a stored image; eps a float64
    scalar or (C,) vector, zp the stored zero point."""

    eps: np.ndarray
    zp: int
    spec: QuantSpec

    @staticmethod
    def make(eps, zp: int, spec: QuantSpec) -> "QMeta":
        return QMeta(np.asarray(eps, dtype=np.float64), int(zp), spec)

    @property
    def per_channel(self) -> bool:
        return np.ndim(self.eps) > 0

    @property
    def alpha(self):
        """NEMO offset: real = alpha + eps * image, alpha = -eps * zp."""
        return -self.eps * self.zp


def quantize_affine(x: torch.Tensor, eps, zp: int, spec: QuantSpec, *,
                    rounding: str = "floor") -> torch.Tensor:
    """LQ_y(t) (Eq. 10): stored = clip(floor(x / eps) + zp, store_min,
    store_max); ``rounding="round"`` rounds half to even instead.  A
    python-float eps divides in x's dtype; an array eps in float32 (and
    x is promoted with it), as the reference's jnp promotion does.  The
    divisor is a tensor on x's device: torch's CUDA division by a host
    scalar multiplies by its rounded reciprocal."""
    if isinstance(eps, (int, float)):
        scaled = x / torch.full((), float(eps), dtype=x.dtype,
                                device=x.device)
    else:
        e = torch.as_tensor(np.asarray(eps, np.float32), device=x.device)
        scaled = x.to(torch.promote_types(x.dtype, e.dtype)) / e
    if rounding == "floor":
        q = torch.floor(scaled)
    elif rounding == "round":
        q = torch.round(scaled)
    else:
        raise ValueError(rounding)
    q = torch.clamp(q + zp, spec.store_min, spec.store_max)
    return q.to(spec.dtype)


def dequantize(stored: torch.Tensor, eps, zp: int) -> torch.Tensor:
    """real = eps * (stored - zp), in float32."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=stored.device)
    return (stored.to(torch.float32) - zp) * eps


def fake_quantize(x: torch.Tensor, eps, zp: int, spec: QuantSpec, *,
                  rounding: str = "floor") -> torch.Tensor:
    """quantize then dequantize (the FQ forward restriction)."""
    return dequantize(quantize_affine(x, eps, zp, spec, rounding=rounding),
                      eps, zp)


def act_qmeta(beta: float, spec: QuantSpec = UINT8,
              alpha: float = 0.0) -> QMeta:
    """Quantum of a clipped activation on [alpha, beta) (paper §2.2):
    eps = (beta - alpha) / (2^Q - 1), alpha stored at store_min."""
    if beta <= alpha:
        raise ValueError(f"need beta > alpha, got [{alpha}, {beta})")
    eps = (beta - alpha) / (spec.levels - 1)
    zp_eff = spec.zero_point - int(round(alpha / eps))
    return QMeta.make(eps, zp_eff, spec)


def weight_qmeta(w: np.ndarray, spec: QuantSpec = INT8,
                 channel_axis: Optional[int] = 0) -> QMeta:
    """Symmetric weight quantum eps = 2 beta / (2^Q - 1), beta the
    per-channel (or whole-tensor) max |w|."""
    w = np.asarray(w)
    if channel_axis is None:
        beta = np.maximum(np.max(np.abs(w)), 1e-8)
    else:
        axes = tuple(i for i in range(w.ndim) if i != channel_axis)
        beta = np.maximum(np.max(np.abs(w), axis=axes), 1e-8)
    eps = 2.0 * beta / (spec.levels - 1)
    return QMeta.make(eps, 0, spec)


def _channel_eps(meta: QMeta, ndim: int, channel_axis: Optional[int]):
    eps = meta.eps
    if meta.per_channel and channel_axis is not None:
        shape = [1] * ndim
        shape[channel_axis] = -1
        eps = eps.reshape(shape)
    return eps


def quantize_np(x: np.ndarray, meta: QMeta, *, rounding: str = "round",
                channel_axis: Optional[int] = None) -> np.ndarray:
    """Host-side quantization to the stored image (transform time)."""
    scaled = x / _channel_eps(meta, x.ndim, channel_axis)
    q = np.floor(scaled) if rounding == "floor" else np.round(scaled)
    q = np.clip(q + meta.zp, meta.spec.store_min, meta.spec.store_max)
    return q.astype(meta.spec.np_dtype)


def dequantize_np(q: np.ndarray, meta: QMeta, *,
                  channel_axis: Optional[int] = None) -> np.ndarray:
    return ((q.astype(np.float64) - meta.zp)
            * _channel_eps(meta, q.ndim, channel_axis))
