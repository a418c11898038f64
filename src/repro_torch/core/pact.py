"""PACT-style fake quantization with straight-through estimators (port
of `repro.core.pact`; paper §2).

FakeQuantized forward-prop restricts tensors to quantized grids while
the backward pass flows through the full-precision values:

    activations  y     = floor(clip_[0,beta)(x) / eps) * eps,
                 eps   = beta / (2^Q - 1)
                 dL/dx    = chi_[0,beta)(x) * dL/dy
                 dL/dbeta = sum((x >= beta) * dL/dy)
    asymmetric   clip to [alpha, beta), image [0, 2^Q - 1]:
                 y = alpha + floor((x - alpha) / eps) * eps,
                 eps = (beta - alpha) / (2^Q - 1)
                 dL/dx     = chi_[alpha,beta)(x) * dL/dy
                 dL/dalpha = sum((x < alpha) * dL/dy)
                 dL/dbeta  = sum((x >= beta) * dL/dy)
    weights      w_hat = eps * clip(floor(w / eps), qmin, qmax),
                 eps   = 2 * beta_w / (2^Q - 1), beta_w per out-channel
                 dL/dw = chi_[-beta_w, beta_w)(w) * dL/dw_hat; beta_w
                 gets none (it tracks max|w|, reset_alpha_weights)

Each is a `torch.autograd.Function` whose backward is the reference's
custom VJP: the masks compare in float32, the clip gradients are
float32 sums of the incoming gradient rounded to its dtype, then to the
clip's.  The forward's quantization math is float32 and its result is
cast back to the input's dtype (bf16 cannot resolve a 2^8-level grid).
"""
from __future__ import annotations

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c rounded once, as the reference divides: the constant goes
    to a's device, since torch's CUDA division by a host scalar
    multiplies by its rounded reciprocal instead."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _clip_grad(g: torch.Tensor, where: torch.Tensor,
               like: torch.Tensor) -> torch.Tensor:
    """sum(where * g) as the reference's jnp.sum computes it (float32
    accumulation, the result in g's dtype), cast to the clip's dtype."""
    s = torch.where(where, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device))
    return s.sum(dtype=torch.float32).to(g.dtype).to(like.dtype).reshape(
        like.shape)


class _PactAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta, n_bits):
        ctx.save_for_backward(x, beta)
        xf = x.to(torch.float32)
        eps = _div(beta.to(torch.float32), 2 ** n_bits - 1)
        q = torch.clamp(torch.floor(xf / eps), 0.0, 2 ** n_bits - 1)
        return (q * eps).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, beta = ctx.saved_tensors
        xf, b = x.to(torch.float32), beta.to(torch.float32)
        dx = torch.where((xf >= 0.0) & (xf < b), g, torch.zeros_like(g))
        return dx, _clip_grad(g, xf >= b, beta), None


class _PactActAsymm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, n_bits):
        ctx.save_for_backward(x, alpha, beta)
        xf = x.to(torch.float32)
        a = alpha.to(torch.float32)
        eps = _div(beta.to(torch.float32) - a, 2 ** n_bits - 1)
        q = torch.clamp(torch.floor((xf - a) / eps), 0.0, 2 ** n_bits - 1)
        return (a + q * eps).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, alpha, beta = ctx.saved_tensors
        xf = x.to(torch.float32)
        a, b = alpha.to(torch.float32), beta.to(torch.float32)
        dx = torch.where((xf >= a) & (xf < b), g, torch.zeros_like(g))
        return (dx, _clip_grad(g, xf < a, alpha),
                _clip_grad(g, xf >= b, beta), None)


def _bcast(beta_w: torch.Tensor, ndim: int, channel_axis: int):
    if beta_w.dim() == 0:
        return beta_w
    shape = [1] * ndim
    shape[channel_axis] = -1
    return beta_w.reshape(shape)


class _PactWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, beta_w, n_bits, channel_axis):
        ctx.save_for_backward(w, beta_w)
        ctx.channel_axis = channel_axis
        b = _bcast(beta_w, w.dim(), channel_axis)
        eps = _div(2.0 * b, 2 ** n_bits - 1)
        qmax = 2 ** (n_bits - 1) - 1
        qmin = -(2 ** (n_bits - 1))
        q = torch.clamp(torch.floor(w / eps), qmin, qmax)
        return q * eps

    @staticmethod
    def backward(ctx, g):
        w, beta_w = ctx.saved_tensors
        b = _bcast(beta_w, w.dim(), ctx.channel_axis)
        dw = torch.where((w >= -b) & (w < b), g, torch.zeros_like(g))
        return dw, torch.zeros_like(beta_w), None, None


def pact_act(x: torch.Tensor, beta, n_bits: int) -> torch.Tensor:
    """FQ forward of a ReLU-family Quantization/Activation (alpha 0);
    beta a float or a 0-d float32 tensor (learnable)."""
    if not isinstance(beta, torch.Tensor):
        beta = _f32(beta, x.device)
    return _PactAct.apply(x, beta, n_bits)


def pact_act_asymm(x: torch.Tensor, alpha, beta, n_bits: int
                   ) -> torch.Tensor:
    """FQ forward of an activation clipped to [alpha, beta) (SiLU / GELU
    outputs), both clips learnable."""
    if not isinstance(alpha, torch.Tensor):
        alpha = _f32(alpha, x.device)
    if not isinstance(beta, torch.Tensor):
        beta = _f32(beta, x.device)
    return _PactActAsymm.apply(x, alpha, beta, n_bits)


def pact_weight(w: torch.Tensor, beta_w, n_bits: int,
                channel_axis: int = -1) -> torch.Tensor:
    """FQ weight restriction w -> w_hat; beta_w broadcasts along
    ``channel_axis`` (per out-channel) or is a scalar (layer-wise)."""
    if not isinstance(beta_w, torch.Tensor):
        beta_w = torch.as_tensor(beta_w, device=w.device)
    return _PactWeight.apply(w, beta_w, n_bits, channel_axis)


def default_weight_beta(w: torch.Tensor, channel_axis: int = -1
                        ) -> torch.Tensor:
    """reset_alpha_weights(): per-out-channel max|w| (never zero).  No
    gradient reaches it through `pact_weight`, so it is taken off the
    graph."""
    axes = tuple(i for i in range(w.dim()) if i != channel_axis % w.dim())
    return torch.clamp(torch.amax(torch.abs(w.detach()), dim=axes),
                       min=1e-8)
