"""PACT-style fake quantization, the forwards (port of the forwards of
`repro.core.pact`; paper §2).

FakeQuantized forward-prop restricts tensors to quantized grids:

    activations  y     = floor(clip_[0,beta)(x) / eps) * eps,
                 eps   = beta / (2^Q - 1)
    weights      w_hat = eps * clip(floor(w / eps), qmin, qmax),
                 eps   = 2 * beta_w / (2^Q - 1), beta_w per out-channel

The quantization math is float32, as the reference's is.  The
reference trains through these with straight-through estimators; the
port has no backward yet (ROADMAP item 11), and autograd's gradient of
`floor` is zero, a wrong STE.  So each function raises when an input
requires a gradient instead of returning a tensor that would train
silently wrong.
"""
from __future__ import annotations

import torch


def _no_grad(*ts) -> None:
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
        raise NotImplementedError(
            "the PACT straight-through backward is not ported yet "
            "(ROADMAP item 11): call the FakeQuantized forward on tensors "
            "that do not require grad")


def pact_act(x: torch.Tensor, beta, n_bits: int) -> torch.Tensor:
    """FQ forward for a ReLU-family Quantization/Activation (alpha 0)."""
    _no_grad(x, beta)
    xf = x.to(torch.float32)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    eps = beta / (2 ** n_bits - 1)
    q = torch.clamp(torch.floor(xf / eps), 0.0, 2 ** n_bits - 1)
    return (q * eps).to(x.dtype)


def _bcast(beta_w: torch.Tensor, ndim: int, channel_axis: int):
    if beta_w.dim() == 0:
        return beta_w
    shape = [1] * ndim
    shape[channel_axis] = -1
    return beta_w.reshape(shape)


def pact_weight(w: torch.Tensor, beta_w, n_bits: int,
                channel_axis: int = -1) -> torch.Tensor:
    """FQ weight restriction w -> w_hat; beta_w broadcasts along
    ``channel_axis`` (per out-channel) or is a scalar (layer-wise)."""
    _no_grad(w, beta_w)
    b = _bcast(torch.as_tensor(beta_w, device=w.device), w.dim(),
               channel_axis)
    eps = 2.0 * b / (2 ** n_bits - 1)
    qmax = 2 ** (n_bits - 1) - 1
    qmin = -(2 ** (n_bits - 1))
    q = torch.clamp(torch.floor(w / eps), qmin, qmax)
    return q * eps


def default_weight_beta(w: torch.Tensor, channel_axis: int = -1
                        ) -> torch.Tensor:
    """reset_alpha_weights(): per-out-channel max|w| (never zero)."""
    axes = tuple(i for i in range(w.dim()) if i != channel_axis % w.dim())
    return torch.clamp(torch.amax(torch.abs(w), dim=axes), min=1e-8)
