"""Integer-only softmax (port of `repro.core.intsoftmax`: the
`attn_softmax="int"` island of the attention, which leaves no float
operation in it).

exp(x) for x <= 0 is split as 2^(-z) * exp(r), z = floor(-x / ln2),
r = x + z ln2 in (-ln2, 0]; exp(r) is a 256-entry LUT over an
r-quantized grid and 2^(-z) a right shift of the LUT's output.  On
int32 scores s of quantum eps_s:

    m = rowmax(s), t = s - m (<= 0), t_c = max(t, -2^26)
    z = min((((-t_c) * m_ln2) >> 12) >> 12, 30)
    r = t_c + z * ln2_img
    e = LUT[clip((-r) // r_step, 0, 255)] >> min(z, 31), 0 where t <= -2^26
    p = (127 e + (sum(e) >> 1)) // max(sum(e), 1), clipped to [0, 127]

giving the int8 probability image of quantum 1/127, the float
island's interface.

`make_int_softmax_tables` is a numpy copy of the reference's
(transform time).  `int_softmax` is the reference's function in torch
integer ops, int32 throughout, with the reference's (XLA's) semantics
kept where int32 overflows rather than avoided: `(-t_c) * m_ln2` wraps
on every masked lane once m_ln2 >= 32 and on lanes whose logit gap
passes about 88, the wrapped z may come out negative, `r` may wrap
again.  So the products stay int32 (torch keeps int32 x int32 in
int32, and the 0-d int32 tables do not promote), the row sum takes
``dtype=torch.int32`` (torch would sum int32 into int64), divisions
floor, and a right shift by a negative amount fills with the sign bit
as XLA's does (written out, not left to the device).  The tables'
scalars are 0-d int32 tensors on the scores' device, read as operands:
no step reads them on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

EXP_BITS = 14          # exp LUT output precision
R_LEVELS = 256         # staircase resolution over (-ln2, 0]
MASKED = -(2 ** 30)    # the masked lanes' score
T_FLOOR = -(2 ** 26)   # t at or below this: the lane's exp is 0


def make_int_softmax_tables(eps_s: float) -> dict:
    """Static tables for score quantum eps_s (host side, numpy): the
    reference's, leaf for leaf (np.int32 scalars, a (256,) int32 LUT)."""
    ln2 = float(np.log(2.0))
    d_ln2 = 24
    m_ln2 = int(np.floor(eps_s / ln2 * (1 << d_ln2)))
    ln2_img = int(np.round(ln2 / eps_s))
    step = max(1, int(np.ceil(ln2_img / R_LEVELS)))
    r_real = -np.arange(R_LEVELS) * step * eps_s
    lut = np.round(np.exp(r_real) * (1 << EXP_BITS)).astype(np.int32)
    return {
        "m_ln2": np.int32(m_ln2), "d_ln2": np.int32(d_ln2),
        "ln2_img": np.int32(ln2_img), "r_step": np.int32(step),
        "exp_lut": lut,
    }


SCALARS = ("m_ln2", "d_ln2", "ln2_img", "r_step")


def int_softmax_load(tables: dict) -> dict:
    """One layer's `sm_tabs` as torch tensors -> what `int_softmax`
    reads, once when the tables are loaded: each scalar a 0-d int32
    tensor of its own (not a view into the layer-stacked leaf), the LUT
    a contiguous (256,) int32.  Raises on another dtype: an int64 table
    would promote the products to int64 and lose the reference's int32
    wraps."""
    for k in SCALARS + ("exp_lut",):
        if tables[k].dtype != torch.int32:
            raise ValueError(f"sm_tabs[{k!r}] must be int32, got "
                             f"{tables[k].dtype}")
    if tables["exp_lut"].shape != (R_LEVELS,):
        raise ValueError(f"exp_lut must be ({R_LEVELS},)")
    out = {k: tables[k].reshape(()).clone() for k in SCALARS}
    out["exp_lut"] = tables["exp_lut"].contiguous()
    return out


def _shift_right(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Arithmetic x >> n for n <= 31 with XLA's out-of-range rule: a
    negative amount (read as unsigned, past the width) fills with the
    sign bit."""
    return torch.where(n >= 0, x >> n.clamp(min=0), x >> 31)


def int_softmax(s: torch.Tensor, tables: dict, *,
                mask: Optional[torch.Tensor] = None,
                p_bits: int = 7) -> torch.Tensor:
    """int32 scores (.., T) -> int8 probability image over the last
    axis.  `tables`: `make_int_softmax_tables`'s tree as torch int32 on
    s's device (0-d scalars, the (256,) LUT); `mask` a bool tensor
    broadcasting against s, True = keep."""
    i32 = torch.int32
    s = s.to(i32)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), MASKED, dtype=i32,
                                            device=s.device))
    t = s - s.amax(dim=-1, keepdim=True)
    t_c = t.clamp(min=T_FLOOR)
    z = (((-t_c) * tables["m_ln2"]) >> 12) >> 12
    z = z.clamp(max=EXP_BITS + 16)
    r = t_c + z * tables["ln2_img"]
    idx = torch.div(-r, tables["r_step"], rounding_mode="floor")
    e = tables["exp_lut"][idx.clamp(0, R_LEVELS - 1)]
    e = _shift_right(e, z.clamp(max=31))
    e = torch.where(t <= T_FLOOR, torch.zeros((), dtype=i32,
                                              device=s.device), e)
    denom = e.sum(dim=-1, keepdim=True, dtype=i32).clamp(min=1)
    pmax = (1 << p_bits) - 1
    p = torch.div(e * pmax + (denom >> 1), denom, rounding_mode="floor")
    return p.clamp(0, pmax).to(torch.int8)


def int_softmax_ref_float(s: torch.Tensor, eps_s: float, *,
                          mask: Optional[torch.Tensor] = None,
                          p_bits: int = 7) -> torch.Tensor:
    """Float oracle: softmax(s eps_s) (masked lanes at -1e9) rounded to
    the same image grid (tests)."""
    x = s.to(torch.float32) * eps_s
    if mask is not None:
        x = torch.where(mask, x, -1e9)
    p = torch.softmax(x, dim=-1)
    return torch.round(p * ((1 << p_bits) - 1)).to(torch.int8)
