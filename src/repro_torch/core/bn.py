"""Batch-Normalization under quantization (port of `repro.core.bn`;
paper §3.4).

Three deployment strategies:

  (i)   *folding* into the preceding Linear (Eq. 18), transform time;
  (ii)  *integer BN* (Eq. 21-22): quantize kappa = gamma/sigma and
        lambda = beta - kappa*mu, run Q_phi = Q_k*Q_phi + Q_phi(lambda)
        on integer images;
  (iii) *threshold merge* with the following Quantization/Activation
        (Eq. 19-20): BN and quantization absorbed into integer
        thresholds TH_i, with no approximation.

The table builders (`fold_bn`, `make_integer_bn`,
`make_bn_act_thresholds`) are the reference's float64 numpy, so the
tables come out equal bit for bit.  The runtime ops (`apply_integer_bn`,
`apply_thresholds`) take int32 torch tensors on any device.

`apply_thresholds` counts the thresholds at or below each value.  The
reference compares every value with every threshold, which takes L-1
times the input's memory (255 times at 8 bits); the port finds the
count by binary search, `torch.searchsorted` channel by channel, which
gives the same count because each channel's thresholds are
non-decreasing (sigma/gamma > 0 and `ceil` is monotone;
`thresholds_to_torch` holds the loaded tables to it).  The reference's
form stays beside it as `threshold_count`, which the tests hold the
search against.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantum import INT8, QuantSpec


# ---------------------------------------------------------------------------
# (i) BN folding, Eq. 18  (host-side, transform time)
# ---------------------------------------------------------------------------


def fold_bn(w: np.ndarray, b, gamma, beta, mu, sigma, *,
            channel_axis: int = -1):
    """w <- gamma/sigma * w ;  b <- gamma/sigma * b + beta - gamma/sigma * mu
    (a bias of the layer sits inside the BN's affine map and is scaled
    by kappa too)."""
    w = np.asarray(w, np.float64)
    kappa = np.asarray(gamma, np.float64) / np.asarray(sigma, np.float64)
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    w_f = w * kappa.reshape(shape)
    b = np.float64(0.0) if b is None else np.asarray(b, np.float64)
    b_f = (
        kappa * b
        + np.asarray(beta, np.float64)
        - kappa * np.asarray(mu, np.float64)
    )
    return w_f, b_f


# ---------------------------------------------------------------------------
# (ii) Integer BN, Eq. 21-22
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntegerBNParams:
    """Static tables: Q_k(kappa) int8 per channel, Q_phi(lambda) int32.

    phi_hat = eps_k*eps_phi * (Q_k * Q_phi + Q_lambda_rq), with
    ``pre_shift`` applied to Q_phi before the multiply to keep the int32
    budget for wide accumulators.
    """

    q_kappa: np.ndarray   # (C,) int8
    q_lambda: np.ndarray  # (C,) int32
    pre_shift: int
    eps_out: np.ndarray   # eps_k * eps_phi * 2^pre_shift (per channel, f64)


def make_integer_bn(
    gamma, beta, mu, sigma, eps_phi, *,
    kappa_spec: QuantSpec = INT8,
    acc_bound: float = 1 << 22,
) -> IntegerBNParams:
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    eps_phi = np.asarray(eps_phi, np.float64)

    kappa = gamma / sigma
    lam = beta - kappa * mu

    # symmetric quantizer for kappa (paper: eps = 2*beta_k/(2^Q - 1))
    beta_k = np.maximum(np.max(np.abs(kappa)), 1e-12)
    eps_k = 2.0 * beta_k / (kappa_spec.levels - 1)
    q_kappa = np.clip(
        np.round(kappa / eps_k), kappa_spec.qmin, kappa_spec.qmax
    )

    # int32 budget: |q_k * (q_phi >> s)| < 2^30
    kmax = float(np.max(np.abs(q_kappa)))
    need = np.log2(max(kmax * acc_bound, 1.0))
    pre_shift = int(max(0, np.ceil(need - 30)))

    eps_out = eps_k * eps_phi * (1 << pre_shift)
    q_lambda = np.round(lam / eps_out).astype(np.int64)
    if np.any(np.abs(q_lambda) >= np.int64(1) << 31):
        raise ValueError("integer BN lambda overflows int32")

    return IntegerBNParams(
        q_kappa=q_kappa.astype(np.int8),
        q_lambda=q_lambda.astype(np.int32),
        pre_shift=pre_shift,
        eps_out=np.broadcast_to(eps_out, kappa.shape).copy(),
    )


def integer_bn_to_torch(p: IntegerBNParams, device="cuda") -> dict:
    """The runtime form of `IntegerBNParams` on `device`: q_kappa and
    q_lambda as int32 tensors (the reference casts q_kappa to int32 at
    every call), pre_shift a Python int.  eps_out is transform-time
    only and stays behind."""
    return {
        "q_kappa": torch.from_numpy(
            np.asarray(p.q_kappa).astype(np.int32)).to(device),
        "q_lambda": torch.from_numpy(
            np.ascontiguousarray(p.q_lambda, np.int32)).to(device),
        "pre_shift": int(p.pre_shift),
    }


def apply_integer_bn(q_phi: torch.Tensor, p: dict) -> torch.Tensor:
    """Q_phi(phi) = Q_k(kappa) * (Q_phi(varphi) >> pre_shift) +
    Q_phi(lambda) (Eq. 22), int32 with the reference's wraps; channels
    on the last axis, ``p`` from `integer_bn_to_torch`."""
    q = torch.bitwise_right_shift(q_phi.to(torch.int32), p["pre_shift"])
    return q * p["q_kappa"] + p["q_lambda"]


# ---------------------------------------------------------------------------
# (iii) Threshold merge, Eq. 19-20
# ---------------------------------------------------------------------------


def make_bn_act_thresholds(
    gamma, beta, mu, sigma, eps_phi, eps_y, n_levels: int,
    *, rounded: bool = False,
) -> np.ndarray:
    """TH_i = ceil((sigma/gamma * i * eps_y - beta*sigma/gamma + mu)
    / eps_phi).

    Returns (C, n_levels-1) int64 thresholds for i = 1..n_levels-1;
    requires gamma, sigma > 0.  ``rounded=True`` places them at
    (i - 1/2) * eps_y, which turns the absorbed quantizer from Eq. 10's
    floor into round-to-nearest (the low-bitwidth CNN deploys use it).
    """
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    if np.any(gamma <= 0) or np.any(sigma <= 0):
        raise ValueError("threshold merge requires gamma, sigma > 0")
    i = np.arange(1, n_levels, dtype=np.float64)[None, :]  # (1, L-1)
    if rounded:
        i = i - 0.5
    s_over_g = (sigma / gamma)[:, None]
    th = (
        s_over_g * i * float(eps_y) - beta[:, None] * s_over_g + mu[:, None]
    ) / float(eps_phi)
    return np.ceil(th).astype(np.int64)


def thresholds_to_torch(th: np.ndarray, device="cuda") -> torch.Tensor:
    """(C, L-1) int64 thresholds -> int32 on `device`, cast as the
    reference casts them (`jnp.asarray(th, jnp.int32)`: two's-complement
    wrap, not a clamp), rows checked non-decreasing (the binary search
    of `apply_thresholds` needs them so)."""
    t = np.asarray(th, np.int64).astype(np.int32)
    # non-decreasing by construction; only a wrap of the cast (a
    # threshold past 2^31, which no int32 accumulator reaches) breaks it
    if np.any(np.diff(t, axis=-1) < 0):
        raise ValueError("thresholds must be non-decreasing in every "
                         "channel after the int32 cast")
    return torch.from_numpy(t).to(device)


# elements of the (rows, C, L-1) comparison block `threshold_count`
# holds at a time
_COUNT_BLOCK = 1 << 24


def threshold_count(q_phi: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """#{i : q_phi >= TH_i} by comparing with every threshold (Eq. 20, the
    reference's form, which the tests hold `apply_thresholds` against),
    over blocks of rows so that no block holds more than _COUNT_BLOCK
    comparisons.  q_phi (..., C) int32, th (C, L-1) int32 -> int32
    counts of q_phi's shape."""
    C, L = th.shape
    q = q_phi.to(torch.int32).reshape(-1, C)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    rows = max(1, _COUNT_BLOCK // max(C * L, 1))
    for r0 in range(0, q.shape[0], rows):
        ge = q[r0:r0 + rows, :, None] >= th
        out[r0:r0 + rows] = ge.sum(-1, dtype=torch.int32)
    return out.reshape(q_phi.shape)


def apply_thresholds(q_phi: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """Q_y = #{i : q_phi >= TH_i} (Eq. 20): integer-only, exact.
    q_phi (..., C), th (C, L-1) int32 from `thresholds_to_torch`.  The
    number of thresholds <= q is `searchsorted(th[c], q, right=True)`
    for each channel's non-decreasing row, repeated thresholds
    included."""
    C = th.shape[0]
    q = q_phi.to(torch.int32).reshape(-1, C).t().contiguous()  # (C, P)
    cnt = torch.searchsorted(th.contiguous(), q, right=True, out_int32=True)
    return cnt.t().reshape(q_phi.shape)


def bn_apply_float(x: torch.Tensor, gamma, beta, mu, sigma) -> torch.Tensor:
    """Reference FP BN (Eq. 3): gamma/sigma * (x - mu) + beta, channels
    on the last axis, in the reference's order of operations."""
    return gamma / sigma * (x - mu) + beta
