"""Float islands of the ID path written as fixed float32 sequences:
`exp_f32`, `log_f32`, `log1p_f32` and `softplus_f32`, the selective
scan's transcendental functions (`layers.ssm`); `lane8_halves`, its
Mamba-1 h * C sum over a bfloat16 state; `rsqrt_f32`,
`window_sum` and `lane8_dot`, the Mamba-2 island's reciprocal square
root, mean and state contraction; `exp_image`, the blockwise
attention's probability image (`layers.attention`); `softmax_f32`, the
float forward's softmax as the reference computes `jax.nn.softmax`; and
`tanh_f32`, the GELU's tanh.

The reference leaves these to XLA, which on the CPU lowers them to
Cephes-style polynomials with every multiply-add contracted into a
fused multiply-add, and runs with denormals flushed to zero.  A library
exp or log1p differs between the card and the CPU (libdevice against
the host's vector maths) on a few percent of float32 inputs.  So each
function here is a fixed sequence of elementwise torch operations,
every one rounded once to float32, the same on both devices; it follows
the reference's lowering step for step (constants, evaluation order,
which products are fused), so it gives the reference's bits on the
inputs the tests sweep (`tests/test_torch_ssm.py`).

`fma(a, b, c)` is the fused multiply-add, rounded once as the
hardware's is (emulated in float64 with the sum rounded to odd).
`ftz` flushes float32 subnormals to a zero of the same sign, as the
reference's host runs do.

The FakeQuantized forward differentiates through these sequences.
Where one reads bits (`fma`, `exp_f32`, `softplus_f32`, `rsqrt_f32`,
`tanh_f32`, `softmax_f32`) or flushes them (`ftz`), it runs as a
`torch.autograd.Function` whose forward is the same sequence and whose
backward is the function's analytic derivative (exp: y g; softplus:
sigmoid(x) g; rsqrt: -y^3 g / 2; tanh: (1 - y^2) g; softmax: y (g -
sum y g); fma as a b + c; ftz as the identity), as jax differentiates
the reference's plain operations.  Without a gradient to carry (serving,
calibration) each runs its sequence alone; the bits are the same
either way.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
F64 = torch.float64
FLT_MIN = float(np.finfo(np.float32).tiny)  # 2^-126, the least normal


def _k(v) -> float:
    """A constant rounded to float32 (as the reference's lowering
    stores it), as the Python float that holds it exactly."""
    return float(np.float32(v))


def _grad_on(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _fma(a, b, c) -> torch.Tensor:
    """round_f32(a * b + c) for float32 tensors or constants, rounded
    once: the product is exact in float64, the sum is rounded to odd in
    float64 (its rounding error, exact by TwoSum, moves an even result
    to the odd neighbour on the error's side), and a sum rounded to odd
    with 29 spare bits rounds to float32 as the exact value does."""
    a64 = a.to(F64) if isinstance(a, torch.Tensor) else _k(a)
    b64 = b.to(F64) if isinstance(b, torch.Tensor) else _k(b)
    c64 = c.to(F64) if isinstance(c, torch.Tensor) else _k(c)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, np.inf), err))
    return torch.where((err != 0) & even, away, s).to(F32)


def _meta(v):
    return (v.shape, v.dtype) if isinstance(v, torch.Tensor) else None


def _grad_of(g: torch.Tensor, meta) -> Optional[torch.Tensor]:
    """g reduced to an operand's (shape, dtype); None for a constant."""
    if meta is None:
        return None
    return g.sum_to_size(meta[0]).to(meta[1])


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(*(v for v in (a, b)
                                if isinstance(v, torch.Tensor)))
        ctx.consts = tuple(None if isinstance(v, torch.Tensor) else _k(v)
                           for v in (a, b))
        ctx.metas = tuple(_meta(v) for v in (a, b, c))
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        a, b = (next(saved) if k is None else k for k in ctx.consts)
        ma, mb, mc = ctx.metas
        return _grad_of(g * b, ma), _grad_of(g * a, mb), _grad_of(g, mc)


def fma(a, b, c) -> torch.Tensor:
    """round_f32(a * b + c) for float32 tensors or constants, rounded
    once (`_fma`); its gradient is that of a * b + c."""
    if _grad_on(a, b, c):
        return _Fma.apply(a, b, c)
    return _fma(a, b, c)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


class _Ftz(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _ftz(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values -> a zero of the same sign (the
    identity's gradient)."""
    return _Ftz.apply(x) if _grad_on(x) else _ftz(x)


class _Unary(torch.autograd.Function):
    """y = fn(x) by a fixed sequence, dL/dx = deriv(x, y) g."""

    @staticmethod
    def forward(ctx, x, fn, deriv):
        y = fn(x)
        ctx.save_for_backward(x, y)
        ctx.deriv = deriv
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (g * ctx.deriv(x.to(F32), y)).to(x.dtype), None, None


def _unary(fn, deriv, x: torch.Tensor) -> torch.Tensor:
    return _Unary.apply(x, fn, deriv) if _grad_on(x) else fn(x)


# exp: n = floor(x log2 e + 1/2) clamped to [-127, 127], r = x - n C1 -
# n C2, e^r by a degree-5 polynomial and r + r^2 p(r) + 1, times 2^n
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.4426950408889634
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 x as the reference's lowering computes it;
    results below the least normal float32 are 0."""
    return _unary(_exp_f32, lambda x, y: y, x)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32).clamp(_k(_EXP_LO), _k(_EXP_HI))
    n = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(n, -_k(_EXP_C1), x)
    r = fma(n, -_k(_EXP_C2), r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = fma(z, r, p)
    z = fma(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(F32)
    y = z * pow2
    return torch.where(y.abs() < FLT_MIN, torch.zeros_like(y), y)


# exp_f32 is within 1.01 ulp of exp over a sweep of 1.6e8 float32 in
# [-8, 0], and the libraries' float32 exp within 2 ulp on both devices;
# with the product's rounding, each 127 e^x in float32 is within 2^-21
# of 127 e^x relatively, so a library exp decides the rounding wherever
# it lies further than 2^-18 of itself from a half-integer
_IMAGE_EDGE = 2.0 ** -18


def exp_image(x: torch.Tensor) -> torch.Tensor:
    """round(127 exp_f32(x)) as int8, for float32 x <= 0 (half to even,
    as the reference's `jnp.round(p * 127.0)` of its lowered exp).

    Only the image is needed, so the library's float32 e^x stands in
    for `exp_f32` wherever 127 e^x lies further than 2^-18 of itself
    from a half-integer (the test below is exact in float32); the few
    entries inside that edge take `exp_f32` (one read of the count, a
    host sync on the card).  The result is the same on every device."""
    x = x.to(F32)
    y = torch.exp(x) * 127.0
    out = torch.round(y)
    edge = (y - torch.floor(y) - 0.5).abs() <= y * _IMAGE_EDGE
    if bool(edge.any()):
        out[edge] = torch.round(exp_f32(x[edge]) * 127.0)
    return out.to(torch.int8)


# rsqrt: the host's 12-bit estimate (a table of 2 x 1024 entries by the
# exponent's parity and the mantissa's top 10 bits, each the estimate at
# its interval's midpoint rounded to 12 bits), then two Newton steps
# y + (y / 2)(1 - x y^2), every multiply-add fused
def _rsqrt_table() -> torch.Tensor:
    i = np.arange(1024, dtype=np.float64)
    mid = 1.0 + (i + 0.5) / 1024.0
    rows = [np.round((2.0 / np.sqrt(mid * s) - 1.0) * 4096.0) for s in (1, 2)]
    return torch.from_numpy(np.stack(rows).astype(np.int32) & 0xFFF)


_RSQRT_TABLE = _rsqrt_table()


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) of positive normal float32 x as the reference's
    lowering computes it on its host (12-bit estimate, two fused Newton
    steps; within 1 ulp, not always the nearest)."""
    return _unary(_rsqrt_f32, lambda x, y: y * y * y * -0.5, x)


def _rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32)
    bits = x.view(torch.int32)
    e = (bits >> 23) - 127
    odd = e & 1
    tab = _RSQRT_TABLE.to(x.device)
    man = tab[odd.long(), ((bits >> 13) & 1023).long()]
    y = (((126 - torch.div(e, 2, rounding_mode="floor")) << 23)
         | (man << 11)).view(F32)
    for _ in range(2):
        y = fma(y * 0.5, fma(-(x * y), y, 1.0), y)
    return y


WINDOW = 32  # the reference's lowering sums long rows in windows of 32


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as the reference's lowering reduces a row
    longer than WINDOW: windows of 32 each summed in order from 0
    (zero-padded at the end), again until at most 32 partial sums are
    left, then those in order; every add rounded once."""
    x = x.to(F32)
    while x.shape[-1] > WINDOW:
        x = F.pad(x, (0, (-x.shape[-1]) % WINDOW))
        w = x.reshape(*x.shape[:-1], -1, WINDOW)
        acc = torch.zeros_like(w[..., 0])
        for i in range(WINDOW):
            acc = acc + w[..., i]
        x = acc
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def lane8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a * b (the same length, a multiple of
    8; broadcastable) as the reference's lowering contracts a batched
    matrix-vector product: lane l of 8 takes the products of indices
    l, l + 8, ... (the first a plain product, the rest fused
    multiply-adds in turn), then adjacent lanes are added pairwise,
    (0 + 1), (2 + 3), ..., then the pairs, then the halves."""
    n = a.shape[-1]

    def groups(x):  # (..., n) -> (n / 8, ..., 8), each group contiguous
        x = x.to(F32)
        return x.reshape(*x.shape[:-1], n // 8, 8).movedim(-2, 0).contiguous()

    a8, b8 = groups(a), groups(b)
    lanes = a8[0] * b8[0]
    for j in range(1, n // 8):
        lanes = fma(a8[j], b8[j], lanes)
    while lanes.shape[-1] > 1:
        lanes = lanes[..., 0::2] + lanes[..., 1::2]
    return lanes[..., 0]


def lane8_halves(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a * b (broadcastable, the length a
    multiple of 8) as the reference's lowering reduces the Mamba-1 h * C
    product when h is a bfloat16 image: lane l of 8 takes the products
    of indices l, l + 8, ... (the first a plain product, the rest fused
    multiply-adds in turn), then the lanes are added by halves, (0..3)
    + (4..7), then (0, 1) + (2, 3), then 0 + 1."""
    a, b = torch.broadcast_tensors(a.to(F32), b.to(F32))
    lanes = a[..., 0:8] * b[..., 0:8]
    for j in range(8, a.shape[-1], 8):
        lanes = fma(a[..., j:j + 8], b[..., j:j + 8], lanes)
    while lanes.shape[-1] > 1:
        n = lanes.shape[-1] // 2
        lanes = lanes[..., :n] + lanes[..., n:]
    return lanes[..., 0]


# log: x = m 2^e with m in [sqrt(1/2), sqrt(2)), log(m) = f - f^2/2 +
# f^3 p(f) for f = m - 1, plus e ln 2 in two parts
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def log_f32(u: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 u as the reference's lowering
    computes it (the least normal stands in for anything below it)."""
    u = u.to(F32).clamp_min(FLT_MIN)
    bits = u.view(torch.int32)
    e = ((bits >> 23) - 127).to(F32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(F32)  # in [0.5, 1)
    small = m < _k(_SQRTHF)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(F32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = fma(fma(x, p[0], p[1]), x, p[2])
    y1 = fma(fma(x, p[3], p[4]), x, p[5])
    y2 = fma(fma(x, p[6], p[7]), x, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _k(_LOG_Q1))
    x = fma(x2, -0.5, x)
    return fma(e, _LOG_Q2, x + y)


# log1p: below sqrt(2) - 1 a (6, 6) rational approximation, x - x^2/2
# + x^3 P(x)/Q(x); above it log(1 + x)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.full_like(x, _k(coefs[0]))
    for c in coefs[1:]:
        p = fma(p, x, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x) of float32 x > -1 as the reference's lowering
    computes it."""
    x = x.to(F32)
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    r = fma(x2, -0.5, (x * x2) * r)
    small = x + r
    return torch.where(x.abs() < _k(_LOG1P_SMALL), small,
                       log_f32(x + 1.0))


def softplus_f32(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's `jax.nn.softplus`:
    max(x, 0) + log1p(exp(-|x|))."""
    return _unary(_softplus_f32, lambda x, y: torch.sigmoid(x), x)


def _softplus_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32)
    return torch.clamp_min(x, 0.0) + log1p_f32(_exp_f32(-x.abs()))


# tanh: x itself below |x| 4e-4, else the input clamped to +-c, x
# p(x^2) / q(x^2) by two polynomials in Horner form, every step fused
_TANH_CLAMP = 7.99881172180175781
_TANH_SMALL = 0.0004
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


def _tanh_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32)
    xc = x.clamp(-_k(_TANH_CLAMP), _k(_TANH_CLAMP))
    x2 = xc * xc
    y = (_horner(x2, _TANH_NUM) * xc) / _horner(x2, _TANH_DEN)
    return torch.where(x.abs() < _k(_TANH_SMALL), x, y)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh of float32 x as the reference's lowering computes it (its
    bits over a sweep of 2.2e5 inputs in [-10, 10]); gradient (1 - y^2)
    g."""
    return _unary(_tanh_f32, lambda x, y: 1.0 - y * y, x)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _softmax_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - torch.sum(y * g, dim=-1, keepdim=True))


def _softmax_f32(x: torch.Tensor) -> torch.Tensor:
    e = _exp_f32(x - x.amax(dim=-1, keepdim=True))
    return e / window_sum(e)[..., None]


def softmax_f32(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of float32 x as the reference's
    `jax.nn.softmax` lowers: the row max, `exp_f32`, the row sum in
    `window_sum`'s order, one divide: its bits on rows of up to 32
    entries or a multiple of 32 (`tests/test_torch_train_moe.py`; on
    other lengths the reference's row sum takes another order).  The
    gradient p (g - sum p g), as jax's."""
    x = x.to(F32)
    return _Softmax.apply(x) if _grad_on(x) else _softmax_f32(x)
