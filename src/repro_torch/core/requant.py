"""Requantization (paper §3.2, Eq. 12-14): host-side table scheduling
plus the runtime integer op on torch tensors.

Port of `repro.core.requant`.  `RequantParams.make` / `make_rqt` are
numpy copies of the reference (transform time, float64 on the host);
`apply_rqt` is the runtime-tree requant on int32 torch tensors and is
the plain version of the requant kernel (kernels/requant_kernel.py):

    q      = clip(q, lo, hi)                       saturation pre-clip
    staged = (q >> s0) * m                         int32, wraps like XLA
    out    = clip((staged >> (d - s0)) + zp, qmin, qmax)

`m/s0/lo/hi` are scalars or per-channel vectors along the last axis;
`d` and `zp` are scalars.  Every operand stays int32: torch promotes
int32 x int64 to int64, which would hide the int32 wraps the reference
has, so the tables are cast to the input's dtype before any arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

DEFAULT_REQUANT_FACTOR = 256  # eta = 1/256 (NEMO's PACT_IntegerAdd default)
_INT32_BUDGET = 30  # keep |q * m| < 2^30 to leave one bit of headroom


@dataclasses.dataclass(frozen=True)
class RequantParams:
    """Static integer tables for one requantization site (see
    `repro.core.requant.RequantParams`)."""

    m: np.ndarray
    d: int
    s0: np.ndarray
    pre_lo: np.ndarray
    pre_hi: np.ndarray
    zp_out: int
    qmin: int
    qmax: int
    out_dtype: str = "int8"

    @staticmethod
    def make(
        eps_in,
        eps_out,
        *,
        zp_out: int = 0,
        qmin: int = -128,
        qmax: int = 127,
        requant_factor: int = DEFAULT_REQUANT_FACTOR,
        acc_bound: Optional[float] = None,
        out_dtype: str = "int8",
        min_d: int = -31,
        stage_slack: int = 2,
    ) -> "RequantParams":
        """Choose (m, d, s0, pre-clip) per Eq. 14 + the int32 budget."""
        eps_in = np.atleast_1d(np.asarray(eps_in, np.float64))
        eps_out = float(np.asarray(eps_out, np.float64))
        if np.any(eps_in <= 0) or eps_out <= 0:
            raise ValueError("quanta must be positive")
        if acc_bound is None:
            acc_bound = 2.0 ** 24
        acc_bound = float(acc_bound)

        ratio = eps_in / eps_out
        eta = 1.0 / requant_factor
        span_hi = float(qmax - zp_out) + 1.0
        span_lo = float(qmin - zp_out) - 1.0

        def _candidate(d: int):
            m = np.floor(ratio * math.pow(2.0, d))
            if np.any(m < 1.0) or np.any(m >= 2.0 ** 31):
                return None
            err = np.abs(ratio - m * math.pow(2.0, -d)) / ratio
            if np.any(err >= eta):
                return None
            scale = m * math.pow(2.0, -d)
            pre_hi = np.minimum(np.ceil(span_hi / scale) + 1.0, 2.0 ** 31 - 1)
            pre_lo = np.maximum(np.floor(span_lo / scale) - 1.0, -(2.0 ** 31))
            eff = np.minimum(
                acc_bound, np.maximum(np.abs(pre_hi), np.abs(pre_lo))
            )
            with np.errstate(divide="ignore"):
                need = np.ceil(np.log2(np.maximum(eff * m, 1.0))).astype(int)
            s0 = np.maximum(np.maximum(need - _INT32_BUDGET, d - 31), 0)
            s0_cap = np.maximum(
                d - np.ceil(np.log2(m)).astype(int) + stage_slack, 0)
            if np.any(s0 > s0_cap) or np.any(s0 > 31):
                return None
            if d < 0 and -d > 31:
                return None
            return m.astype(np.int64), s0, pre_lo, pre_hi

        found = None
        for d in range(min_d, 47):
            found = _candidate(d)
            if found is not None:
                break
        if found is None:
            raise ValueError(
                "requantization site unschedulable in int32: "
                f"eps_in~{float(np.max(eps_in)):g} eps_out={eps_out:g} "
                f"acc_bound={acc_bound:g} (ratio {float(np.max(ratio)):g}, "
                f"eta={eta:g})"
            )
        m, s0, pre_lo, pre_hi = found
        squeeze = eps_in.shape == (1,)

        def _i32(x):
            a = np.asarray(x).astype(np.int64)
            a = np.clip(a, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)
            return a[0] if squeeze and a.shape == (1,) else a

        return RequantParams(
            m=_i32(m), d=int(d), s0=_i32(s0), pre_lo=_i32(pre_lo),
            pre_hi=_i32(pre_hi), zp_out=int(zp_out), qmin=int(qmin),
            qmax=int(qmax), out_dtype=out_dtype,
        )

    def to_tree(self) -> dict:
        """Runtime tree form: every field an int32 numpy array."""
        return {
            "m": np.asarray(self.m, np.int32),
            "d": np.asarray(self.d, np.int32),
            "s0": np.asarray(self.s0, np.int32),
            "lo": np.asarray(self.pre_lo, np.int32),
            "hi": np.asarray(self.pre_hi, np.int32),
            "zp": np.asarray(self.zp_out, np.int32),
        }


def make_rqt(
    eps_in,
    eps_out,
    *,
    zp_out: int = 0,
    qmin: int = -128,
    qmax: int = 127,
    requant_factor: int = DEFAULT_REQUANT_FACTOR,
    acc_bound: Optional[float] = None,
) -> dict:
    """Host-side: RequantParams.make -> runtime tree, d forced >= 0."""
    rp = RequantParams.make(
        eps_in, eps_out, zp_out=zp_out, qmin=qmin, qmax=qmax,
        requant_factor=requant_factor, acc_bound=acc_bound, min_d=0,
    )
    return rp.to_tree()


def apply_rqt(
    q: torch.Tensor,
    rqt: dict,
    *,
    qmin: int = -128,
    qmax: int = 127,
    out_dtype: torch.dtype = torch.int8,
) -> torch.Tensor:
    """Runtime-tree requant on torch tensors (channels on the last
    axis).  ``rqt`` holds int32 tensors {m, d, s0, lo, hi, zp} on the
    same device as ``q``; m/s0/lo/hi are scalars or (C,) vectors."""
    q = q.to(torch.int32)
    m, s0 = rqt["m"].to(torch.int32), rqt["s0"].to(torch.int32)
    lo, hi = rqt["lo"].to(torch.int32), rqt["hi"].to(torch.int32)
    d, zp = rqt["d"].to(torch.int32), rqt["zp"].to(torch.int32)
    q = torch.minimum(torch.maximum(q, lo), hi)
    staged = torch.bitwise_right_shift(q, s0) * m
    out = torch.bitwise_right_shift(staged, d - s0) + zp
    return out.clamp(qmin, qmax).to(out_dtype)
