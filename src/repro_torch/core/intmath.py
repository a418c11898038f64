"""Integer-only math primitives for the ID path (port of
`repro.core.intmath`: `int_isqrt`, `build_lut`, `apply_lut`,
`pack_int4`, `unpack_int4`).

torch has no count-leading-zeros, so the bit length that seeds the
isqrt Newton iteration (and the integer norm's reciprocal) is read off
exactly as the binary exponent of the value (`torch.frexp`) — never
through a float `log2`, which rounds wrongly just below powers of two.
"""
from __future__ import annotations

import numpy as np
import torch


def bit_length(n: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int32 values (0 -> 0, 1 -> 1,
    2^31 - 1 -> 31): the `32 - clz(n)` of the reference.  Exact:
    float64 holds every int32 exactly, and `frexp` splits it into a
    mantissa in [0.5, 1) and the integer exponent, which is the bit
    length — no rounded logarithm is involved."""
    return torch.frexp(n.to(torch.float64)).exponent.to(torch.int32)


def int_isqrt(n: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(n)) for non-negative int32, pure integer: a guess
    of 2^ceil(bits/2) from the exact bit length, six monotone Newton
    steps, then the perfect-square-neighbour fix-up (the reference's
    algorithm step for step, int32 wraps included)."""
    n = n.to(torch.int32)
    bits = bit_length(torch.clamp(n, min=1))
    one = torch.ones_like(n)
    x = torch.bitwise_left_shift(one, torch.bitwise_right_shift(bits + 1, 1))
    for _ in range(6):
        x_new = torch.bitwise_right_shift(
            x + torch.div(n, torch.clamp(x, min=1), rounding_mode="floor"), 1
        )
        x = torch.minimum(x, x_new)
    x = torch.where(x * x > n, x - 1, x)
    return torch.where(n <= 0, torch.zeros_like(x), x)


def build_lut(
    fn,
    eps_in,
    zp_in: int,
    eps_out,
    zp_out: int,
    *,
    qmin: int = -128,
    qmax: int = 127,
) -> np.ndarray:
    """Materialize a pointwise nonlinearity as a 256-entry int8 table
    (host-side, transform time; the paper's Eq. 8/9 staircase)."""
    s = np.arange(qmin, qmax + 1, dtype=np.int64)
    real = (s - zp_in) * float(eps_in)
    y = np.asarray(fn(real), dtype=np.float64)
    t = np.clip(np.round(y / float(eps_out)) + zp_out, qmin, qmax)
    return t.astype(np.int8)


def apply_lut(stored: torch.Tensor, table: torch.Tensor, *,
              qmin: int = -128) -> torch.Tensor:
    """y_stored = table[x_stored - qmin] (integer gather)."""
    idx = stored.to(torch.int64) - qmin
    return table[idx]


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (stored in int8, range [-8, 7]) two per int8
    cell along the LAST axis: element 2i -> low nibble, 2i+1 -> high
    nibble of output cell i.  The last axis must be even.  Works in
    int32 and keeps the low byte, the bits the reference's int8 shifts
    give for every int8 input."""
    if x.shape[-1] % 2:
        raise ValueError(f"last axis must be even, got {x.shape[-1]}")
    lo = x[..., 0::2].to(torch.int32)
    hi = x[..., 1::2].to(torch.int32)
    return (torch.bitwise_left_shift(hi, 4)
            | torch.bitwise_and(lo, 0x0F)).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4`: int8 cells -> int4 values in [-8, 7]
    (stored as int8), last axis doubled.  Each nibble is sign-extended
    in int32 (shift left to the top, then arithmetic shift right):
    torch's int8 shifts promote and would not wrap like the
    reference's."""
    c = p.to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(c, 28), 28)
    hi = torch.bitwise_right_shift(c, 4)
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*p.shape[:-1], 2 * p.shape[-1])
