"""Selective state-space layers under NEMO quantization (port of
`repro.layers.ssm`: `QMamba1`, the falcon_mamba_7b layer, and
`QMamba2`, the zamba2 hybrid's, each with its float forward
`apply_float`, `deploy`, `apply_id` and `init_cache`).

Everything around the scan is W8A8 integer: the projections on the
int8 GEMM (kernels/int8_matmul.py; the in_proj's requant, and Mamba-1's
x_proj's, fused into the epilogue), the depthwise causal conv1d as
int32 torch ops (`causal_conv1d_int`), its requant and SiLU LUT on the
requant kernel (`requant`, `requant_act`), and Mamba-1's gate z (its
LUT, the gate product and `gated_rqt` in one launch of the requant
kernel's gate form, `requant_gate`).  The scan core is the paper's
§3.8 float island: softplus, exp(dt A) and the recurrence h_t = a_t
h_{t-1} + u_t, entered through static dequant scales.  Mamba-1 leaves
it through `eps_y_inv`; Mamba-2 keeps its gate and gated RMS norm
inside the island and leaves through `eps_n_inv`.

The island is a fixed sequence of float32 operations, each rounded
once, the same on the card and the CPU (`core.island`), written as the
reference's XLA lowering computes it: the recurrence as
`jax.lax.associative_scan`'s odd / even recursion (`_scan`) with its
combine's multiply-add fused, over one block when L is not a multiple
of the chunk (`ssm_chunk`, default CHUNK) or below it, else chunk by
chunk with the float32 carry (`_chunked`); every state product flushed
to zero below the least normal float32 (the reference's host runs
flush subnormals).  The state enters as the reference's serving steps
fuse it, h_0 = a_0 h0 + u_0 in one multiply-add (a decode step is that
alone).  Mamba-1 sums h * C over its 16 states as one chain of fused
multiply-adds (`lane_sum_hc`); Mamba-2 contracts h with C as the
reference's batched matrix-vector product (`core.island.lane8_dot`),
adds D x in one fused multiply-add, and takes its gate z / (1 + e^-z),
the mean of the squares (`window_sum`) and `rsqrt_f32` as its lowering
does.

Under the variant ``ssm_island_dtype="bf16"`` the chunked branch alone
changes, as in the reference: each chunk's a, u and incoming state are
rounded to bfloat16 and the scan runs in bfloat16, every operation
computed in float32 and rounded back (the combine's multiply-add as a
rounded product, then the sum; the state enters the same way), the
carry returns to float32, and y reads the bfloat16 h lifted to float32
(Mamba-1's h * C summed in 8 lanes by halves, `core.island.
lane8_halves`).  Shorter or ragged spans and the decode step stay
float32.

Caches (serving): Mamba-1 {"conv": (B, conv_k - 1, d_inner) int8, the
last conv inputs; "h": (B, d_inner, d_state) float32}; Mamba-2 {"conv":
(B, conv_k - 1, d_conv_in) int8 over the x, B, C channels; "h": (B, H,
P, d_state) float32}: the one float leaf of an ID cache tree.  The
float forward's cache (`init_cache(B, rep=Rep.FP)`) holds the conv
window in bfloat16 and h in float32; `apply_float(cache=)` carries both
across calls and returns new ones, the conv window in the dtype the
concatenation promotes to (float32 after a float32 input), as the
reference's `jnp.concatenate` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.intmath import build_lut
from repro_torch.core.island import (
    exp_f32, fma, ftz, lane8_dot, lane8_halves, rsqrt_f32, softplus_f32,
    window_sum,
)
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import (
    requant, requant_act, requant_gate,
)
from repro_torch.launch import variants
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import (
    ACT_QMIN, ActKind, DeployCtx, act_fn, act_fn_np, normal_np,
)
from repro_torch.layers.conv import K_ALIGN
from repro_torch.layers.linear import QLinear

CHUNK = 128


def _chunk_len() -> int:
    return variants.get("ssm_chunk") or CHUNK


def _island_dtype() -> torch.dtype:
    """The chunked scan's dtype: bfloat16 under the variant
    ``ssm_island_dtype="bf16"``, else float32."""
    return (torch.bfloat16 if variants.get("ssm_island_dtype") == "bf16"
            else torch.float32)


# -- the scan ------------------------------------------------------------
def _combine(x, y):
    """(a, u) of an earlier span then a later one -> the whole span's."""
    ax, ux = x
    ay, uy = y
    return ftz(ax * ay), ftz(fma(ay, ux, uy))


def _bf(v: torch.Tensor) -> torch.Tensor:
    """A float32 result -> bfloat16: flushed, then rounded once to
    nearest even, as the reference's lowering converts each bfloat16
    operation it computes in float32."""
    return ftz(v).to(torch.bfloat16)


def _f(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


def _combine_bf16(x, y):
    """`_combine` on bfloat16 pairs as the reference's lowering runs it:
    each operation in float32 and rounded back, the multiply-add as a
    product rounded to bfloat16, then the sum."""
    ax, ux = x
    ay, uy = y
    return _bf(_f(ax) * _f(ay)), _bf(_f(_bf(_f(ay) * _f(ux))) + _f(uy))


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even / odd positions along axis 1 -> one sequence; each entry
    passes through + 0 as in the reference (-0 becomes +0)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out + 0.0


def _scan(a: torch.Tensor, u: torch.Tensor, combine=_combine):
    """`jax.lax.associative_scan(combine, (a, u), axis=1)`: pairs
    combined, the half-length scan recursed, the even positions
    completed from it, and the two interleaved."""
    n = a.shape[1]
    if n < 2:
        return a, u
    ra, ru = combine((a[:, 0:-1:2], u[:, 0:-1:2]), (a[:, 1::2], u[:, 1::2]))
    oa, ou = _scan(ra, ru, combine)
    if n % 2 == 0:
        ea, eu = combine((oa[:, :-1], ou[:, :-1]), (a[:, 2::2], u[:, 2::2]))
    else:
        ea, eu = combine((oa, ou), (a[:, 2::2], u[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eu = torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, oa), _interleave(eu, ou)


def scan_h(a: torch.Tensor, u: torch.Tensor,
           h0: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t along axis 1 (a broadcastable to u); h0
    the state before position 0 (u's shape less axis 1), or None.  ->
    h, u's shape, in ``dtype``: float32 with each multiply-add fused,
    or bfloat16 (a, u and h0 rounded to it, every operation rounded
    back to it, `_combine_bf16`; the state enters as a product, then
    a sum)."""
    if dtype == torch.bfloat16:
        a, u = a.to(dtype), u.to(dtype)
        if h0 is not None:
            ah = _bf(_f(a[:, :1]) * _f(h0.to(dtype)[:, None]))
            u = torch.cat([_bf(_f(u[:, :1]) + _f(ah)), u[:, 1:]], dim=1)
        return _scan(a, u, _combine_bf16)[1]
    if h0 is not None:
        first = ftz(fma(a[:, :1], h0[:, None], u[:, :1]))
        u = torch.cat([first, u[:, 1:]], dim=1)
    return _scan(a, u)[1]


def assoc_scan(a: torch.Tensor, dt_b: torch.Tensor, x1: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t along axis 1 with u = dt_b * x1 (a, dt_b
    (B, L, di, ds), x1 (B, L, di, 1)); h0 (B, di, ds) the state before
    position 0, or None.  -> h (B, L, di, ds) in ``dtype``
    (`scan_h`)."""
    return scan_h(a, ftz(dt_b * x1), h0, dtype)


def _chunked(L: int, block, h0: Optional[torch.Tensor], zeros):
    """The reference's `_chunked_recurrence` around `block(span, h_prev,
    dtype) -> (y, h_last)`: one block over all L positions in float32
    when L is not a multiple of the chunk or below it (h_prev = h0,
    maybe None), else chunk by chunk from h0 or `zeros()` with the scan
    in the island's dtype (`_island_dtype`) and the carry in float32
    (each chunk rematerialised in the backward pass when gradients are
    on)."""
    chunk = _chunk_len()
    if L % chunk or L < chunk:
        return block(slice(None), h0, torch.float32)
    dtype = _island_dtype()
    h = zeros() if h0 is None else h0
    ys = []
    for c0 in range(0, L, chunk):
        span = slice(c0, c0 + chunk)
        if torch.is_grad_enabled():
            # the reference's checkpointed chunk step: the backward keeps
            # each chunk's inputs and carry, and recomputes the rest
            y, h = torch.utils.checkpoint.checkpoint(
                block, span, h, dtype, use_reentrant=False)
        else:
            y, h = block(span, h, dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def lane_sum_hc(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum over the state axis of h (B, L, di, ds) * c (B, L, ds), as
    one chain of fused multiply-adds in lane order from 0."""
    c = c[..., None, :]
    acc = torch.zeros_like(h[..., 0])
    for i in range(h.shape[-1]):
        acc = fma(h[..., i], c[..., i], acc)
    return acc


def ssm_core(x1: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float scan core (the reference's `QMamba1._core_fp`
    through `_chunked_recurrence`): x1, dt (B, L, di), bm, cm (B, L, ds)
    float32, A (di, ds), D (di,), h0 (B, di, ds) or None.  -> (y (B, L,
    di), h_last (B, di, ds))."""

    def block(s: slice, h_prev, dtype):
        dts = dt[:, s]
        a = exp_f32(dts[..., None] * A)
        dt_b = ftz(dts[..., None] * bm[:, s, None, :])
        xs = x1[:, s]
        h = _f(assoc_scan(a, dt_b, xs[..., None], h_prev, dtype))
        hc = (lane_sum_hc(h, cm[:, s]) if dtype == torch.float32
              else lane8_halves(h, cm[:, s, None, :]))
        y = fma(D, xs, hc)
        return y, h[:, -1]

    return _chunked(x1.shape[1], block, h0, lambda: torch.zeros(
        x1.shape[0], A.shape[0], A.shape[1], dtype=torch.float32,
        device=x1.device))


def ssm2_core(xh: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
              cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 scan core (the reference's `QMamba2._core_fp`): xh (B,
    L, H, P), dt (B, L, H), bm, cm (B, L, H or 1, ds) float32 (each
    group's B / C repeated over its heads, or one group for all; (B, L,
    ds) is one group), A, D (H,), h0 (B, H, P, ds) or None.  a = exp(dt
    A) per head, u = dt x B in that order, y = h . C (`lane8_dot`) + D x
    fused.  -> (y (B, L, H, P), h_last (B, H, P, ds))."""
    if bm.dim() == 3:
        bm, cm = bm[:, :, None], cm[:, :, None]

    def block(s: slice, h_prev, dtype):
        dts, xs = dt[:, s], xh[:, s]
        a = exp_f32(dts * A)[..., None, None]
        u = ftz(ftz(dts[..., None, None] * xs[..., None])
                * bm[:, s, :, None, :])
        h = _f(scan_h(a, u, h_prev, dtype))
        y = fma(D[:, None], xs, lane8_dot(h, cm[:, s, :, None, :]))
        return y, h[:, -1]

    B, _, H, P = xh.shape
    return _chunked(xh.shape[1], block, h0, lambda: torch.zeros(
        B, H, P, bm.shape[-1], dtype=torch.float32, device=xh.device))


# -- the integer conv ----------------------------------------------------
def causal_conv1d_int(s_x: torch.Tensor, w_q: torch.Tensor,
                      b_q: torch.Tensor) -> torch.Tensor:
    """int8 s_x (B, L, D), int8 depthwise taps w_q (K, D), int32 b_q
    (D,) -> the int32 accumulator (B, L - K + 1, D) over the valid
    windows: sum_i s_x[:, t + i] * w_q[i] + b_q."""
    K = w_q.shape[0]
    Lo = s_x.shape[1] - K + 1
    acc = b_q.to(torch.int32).expand(s_x.shape[0], Lo, -1).clone()
    for i in range(K):
        acc += s_x[:, i:i + Lo].to(torch.int32) * w_q[i].to(torch.int32)
    return acc


def _causal_conv1d_fp(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = pad[:, 0:x.shape[1]] * w[0]
    for i in range(1, K):
        y = y + pad[:, i:i + x.shape[1]] * w[i]
    return y + b


# ===========================================================================
# Mamba-1 (falcon_mamba_7b)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class QMamba1:
    d_model: int
    d_state: int = 16
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    conv_k: int = 4
    name: str = "mamba"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, int(np.ceil(self.d_model / 16)))

    def _sub(self):
        di, ds, r = self.d_inner, self.d_state, self.rank
        return {
            "in_proj": QLinear(self.d_model, 2 * di),
            "x_proj": QLinear(di, r + 2 * ds),
            "dt_proj": QLinear(self.rank, di, use_bias=True),
            "out_proj": QLinear(di, self.d_model),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        """Float params with the reference's shapes and scales: A_log =
        log(1..d_state) on every channel, D = 1, conv taps normal /
        sqrt(conv_k), zero conv bias, and the dt bias softplus^-1(0.01)
        = log(expm1(0.01))."""
        p = {n: lay.init_np(rng) for n, lay in self._sub().items()}
        di, ds = self.d_inner, self.d_state
        p["A_log"] = np.log(np.broadcast_to(
            np.arange(1, ds + 1, dtype=np.float32)[None, :], (di, ds)))
        p["D"] = np.ones((di,), np.float32)
        p["conv_w"] = normal_np(rng, (self.conv_k, di),
                                1.0 / np.sqrt(self.conv_k))
        p["conv_b"] = np.zeros((di,), np.float32)
        p["dt_proj"]["b"] = np.full((di,), np.log(np.expm1(0.01)),
                                    np.float32)
        return p

    # -- float forward ------------------------------------------------------
    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", cache: Optional[dict] = None, *,
                    rep: Rep = Rep.FP):
        """FullPrecision (or, with ``rep=Rep.FQ``, FakeQuantized: the
        projections on PACT-restricted weights) forward of (B, L, d)
        float -> (out in x's dtype, new cache or None), observing the
        reference's six ranges under ``{scope}{name}.``.  The conv's
        float32 taps lift a bfloat16 input to float32, so the scan runs
        in float32 as in calibration; y returns to x's dtype before the
        gate, as in the reference."""
        subs = self._sub()
        ds, r = self.d_state, self.rank
        nm = f"{scope}{self.name}"
        f32 = torch.float32
        xz = subs["in_proj"].apply(p["in_proj"], x, rep)
        x1, z = torch.chunk(xz, 2, dim=-1)
        if cache is not None:
            conv_in = torch.cat([cache["conv"], x1], dim=1)
            x1c = _causal_conv1d_fp(conv_in, p["conv_w"],
                                    p["conv_b"])[:, -x1.shape[1]:]
            new_conv = conv_in[:, -(self.conv_k - 1):]
        else:
            x1c = _causal_conv1d_fp(x1, p["conv_w"], p["conv_b"])
            new_conv = x1[:, -(self.conv_k - 1):]
        x1a = act_fn(ActKind.SILU, x1c)
        if calib is not None:
            calib.observe(f"{nm}.conv.pre", x1c)
            calib.observe(f"{nm}.conv", x1a)
        xdb = subs["x_proj"].apply(p["x_proj"], x1a, rep)
        dt_r, bm, cm = torch.split(xdb, [r, ds, ds], dim=-1)
        dt = softplus_f32(subs["dt_proj"].apply(p["dt_proj"], dt_r, rep))
        A = -exp_f32(p["A_log"])
        y, h_last = ssm_core(x1a.to(f32), dt, bm.to(f32).contiguous(),
                             cm.to(f32).contiguous(), A, p["D"],
                             h0=None if cache is None else cache["h"])
        y = y.to(x.dtype)
        zs = act_fn(ActKind.SILU, z)
        if calib is not None:
            calib.observe(f"{nm}.y", y)
            calib.observe(f"{nm}.z.pre", z)
            calib.observe(f"{nm}.z", zs)
            calib.observe(f"{nm}.gated", y * zs)
        out = subs["out_proj"].apply(p["out_proj"], y * zs, rep)
        new_cache = ({"conv": new_conv, "h": h_last}
                     if cache is not None else None)
        return out, new_cache

    # -- transform ------------------------------------------------------------
    def deploy(self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float,
               zp_x: int) -> Tuple[dict, np.ndarray]:
        """-> (integer and island tables, eps of out_proj's
        accumulator): the reference's float64 host arithmetic."""
        subs = self._sub()
        t: dict = {}
        nm = f"{scope}{self.name}"
        # in_proj -> split spaces (x1 | z), both symmetric int8
        ip, eps_acc = subs["in_proj"].deploy(p_np["in_proj"], eps_x, zp_x)
        t["in_proj"] = ip
        act_xz = QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.xz")
        txz, eps_xz, _ = act_xz.deploy(ctx, scope, eps_acc, 0,
                                       subs["in_proj"].acc_bound())
        t["xz_rqt"] = txz["rqt"]
        # conv (int8 taps on one per-tensor grid) -> SiLU LUT
        w = np.asarray(p_np["conv_w"], np.float64)
        amax_w = np.maximum(np.abs(w).max(), 1e-8)
        eps_cw = 2.0 * amax_w / 255.0
        t["conv_wq"] = np.clip(np.floor(w / eps_cw), -128,
                               127).astype(np.int8)
        eps_cacc = eps_cw * eps_xz
        t["conv_bq"] = np.round(
            np.asarray(p_np["conv_b"], np.float64) / eps_cacc
        ).astype(np.int32)
        lo, hi = ctx.range(f"{nm}.conv.pre", "ssm")
        amax = max(abs(lo), abs(hi), 1e-6)
        eps_cpre = 2.0 * amax / 255.0
        t["conv_rqt"] = make_rqt(
            eps_cacc, eps_cpre, zp_out=0, requant_factor=ctx.factor,
            acc_bound=self.conv_k * 127.0 * 127.0)
        lo_c, hi_c = ctx.range(f"{nm}.conv", "act_asym")
        eps_conv = (max(hi_c, lo_c + 1e-6) - lo_c) / 255.0
        zp_conv = ACT_QMIN - int(round(lo_c / eps_conv))
        t["conv_lut"] = build_lut(lambda v: act_fn_np(ActKind.SILU, v),
                                  eps_cpre, 0, eps_conv, zp_conv)
        t["zp_conv"] = np.int32(zp_conv)
        # x_proj consumes the asymmetric conv output
        ipx, eps_accx = subs["x_proj"].deploy(p_np["x_proj"], eps_conv,
                                              zp_conv)
        t["x_proj"] = ipx
        act_xdb = QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.xdb")
        txdb, eps_xdb, _ = act_xdb.deploy(ctx, scope, eps_accx, 0,
                                          subs["x_proj"].acc_bound())
        t["xdb_rqt"] = txdb["rqt"]
        # dt_proj int8; its accumulator enters the island (softplus)
        ipdt, eps_accdt = subs["dt_proj"].deploy(p_np["dt_proj"], eps_xdb, 0)
        t["dt_proj"] = ipdt
        t["dt_scale"] = eps_accdt.astype(np.float32)  # per channel (di,)
        # island constants
        t["A"] = -np.exp(np.asarray(p_np["A_log"], np.float32))
        t["Dv"] = np.asarray(p_np["D"], np.float32)
        t["eps_conv_f"] = np.float32(eps_conv)
        t["zp_conv_f"] = np.float32(zp_conv)
        t["eps_xdb_f"] = np.float32(eps_xdb)
        # island exit: y -> symmetric int8
        lo_y, hi_y = ctx.range(f"{nm}.y", "ssm")
        amax_y = max(abs(lo_y), abs(hi_y), 1e-6)
        eps_y = 2.0 * amax_y / 255.0
        t["eps_y_inv"] = np.float32(1.0 / eps_y)
        # gate z: SiLU LUT on the xz space
        lo_z, hi_z = ctx.range(f"{nm}.z", "act_asym")
        eps_z = (max(hi_z, lo_z + 1e-6) - lo_z) / 255.0
        zp_z = ACT_QMIN - int(round(lo_z / eps_z))
        t["z_lut"] = build_lut(lambda v: act_fn_np(ActKind.SILU, v),
                               eps_xz, 0, eps_z, zp_z)
        t["zp_z"] = np.int32(zp_z)
        # gated product -> symmetric int8 -> out_proj
        lo_g, hi_g = ctx.range(f"{nm}.gated", "ssm")
        amax_g = max(abs(lo_g), abs(hi_g), 1e-6)
        eps_gt = 2.0 * amax_g / 255.0
        t["gated_rqt"] = make_rqt(
            eps_y * eps_z, eps_gt, zp_out=0, requant_factor=ctx.factor,
            acc_bound=float(256 * 128))
        ipo, eps_acco = subs["out_proj"].deploy(p_np["out_proj"], eps_gt, 0)
        t["out_proj"] = ipo
        return t, eps_acco

    # -- integer path ---------------------------------------------------------
    def island(self, t: dict, acc_dt: torch.Tensor, s_conv: torch.Tensor,
               s_b: torch.Tensor, s_c: torch.Tensor,
               h0: Optional[torch.Tensor]):
        """The float island: softplus of the dequantized dt accumulator,
        x1, B, C dequantized, the scan, y quantized to int8 by
        `eps_y_inv`.  -> (s_y (B, L, di) int8, h_last float32)."""
        f32 = torch.float32
        dt = softplus_f32(acc_dt.to(f32) * t["dt_scale"])
        x1f = (s_conv.to(f32) - t["zp_conv_f"]) * t["eps_conv_f"]
        bf = s_b.to(f32) * t["eps_xdb_f"]
        cf = s_c.to(f32) * t["eps_xdb_f"]
        y, h_last = ssm_core(x1f, dt, bf, cf, t["A"], t["Dv"], h0=h0)
        s_y = torch.clamp(torch.round(y * t["eps_y_inv"]), -128, 127)
        return s_y.to(torch.int8), h_last

    def apply_id(self, t: dict, s_x: torch.Tensor,
                 cache: Optional[dict] = None):
        """s_x (B, L, d) int8 -> (out_proj's int32 accumulator (B, L,
        d), new cache or None); `t` through `load_core`."""
        subs = self._sub()
        di, ds, r = self.d_inner, self.d_state, self.rank
        s_xz = subs["in_proj"].apply_id(t["in_proj"], s_x, t["xz_rqt"])
        s_x1, s_z = s_xz[..., :di], s_xz[..., di:]
        K = self.conv_k
        if cache is not None:
            conv_in = torch.cat([cache["conv"], s_x1], dim=1)
        else:
            conv_in = F.pad(s_x1, (0, 0, K - 1, 0))
        new_conv = conv_in[:, -(K - 1):]
        c_acc = causal_conv1d_int(conv_in, t["conv_wq"], t["conv_bq"])
        s_cpre = requant(c_acc, t["conv_rqt"])
        s_conv = requant_act(s_cpre, {"lut": t["conv_lut"]})  # asym int8
        s_xdb = subs["x_proj"].apply_id(t["x_proj"], s_conv, t["xdb_rqt"])
        s_dtr = s_xdb[..., :r]
        kp = t["dt_proj"]["w_q"].shape[0]
        if kp != r:
            s_dtr = F.pad(s_dtr, (0, kp - r))
        acc_dt = _dt_proj(t["dt_proj"], s_dtr, di)
        s_y, h_last = self.island(
            t, acc_dt, s_conv, s_xdb[..., r:r + ds], s_xdb[..., r + ds:],
            cache["h"] if cache is not None else None)
        s_g = requant_gate(s_z.contiguous(), s_y, t["z_lut"], t["zp_z"],
                           t["gated_rqt"])
        out = subs["out_proj"].apply_id(t["out_proj"], s_g)
        new_cache = ({"conv": new_conv, "h": h_last}
                     if cache is not None else None)
        return out, new_cache

    def init_cache(self, B: int, device="cuda", rep: Rep = Rep.ID,
                   dtype=None) -> dict:
        """A zeroed cache of B rows: the conv window (int8 at Rep.ID,
        else `dtype`, bfloat16 by default) and the float32 scan state
        at every rep."""
        return {
            "conv": torch.zeros((B, self.conv_k - 1, self.d_inner),
                                dtype=_conv_dtype(rep, dtype),
                                device=device),
            "h": torch.zeros((B, self.d_inner, self.d_state),
                             dtype=torch.float32, device=device),
        }


# ===========================================================================
# Mamba-2 (zamba2)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class QMamba2:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_k: int = 4
    n_groups: int = 1
    name: str = "mamba2"

    def __post_init__(self):
        if self.n_heads % self.n_groups:
            raise ValueError(f"n_groups {self.n_groups} must divide the "
                             f"{self.n_heads} heads")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def d_conv_in(self) -> int:
        """The conv runs over (x, B, C)."""
        return self.d_inner + 2 * self.n_groups * self.d_state

    def _sub(self):
        di, ds, H = self.d_inner, self.d_state, self.n_heads
        return {
            "in_proj": QLinear(self.d_model,
                               2 * di + 2 * self.n_groups * ds + H),
            "out_proj": QLinear(di, self.d_model),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        """Float params with the reference's shapes and scales: A_log =
        log of H values evenly from 1 to 16, D = 1, dt bias
        softplus^-1(0.01), conv taps normal / sqrt(conv_k), zero conv
        bias, norm gain 1."""
        p = {n: lay.init_np(rng) for n, lay in self._sub().items()}
        H = self.n_heads
        p["A_log"] = np.log(np.linspace(1.0, 16.0, H).astype(np.float32))
        p["D"] = np.ones((H,), np.float32)
        p["dt_bias"] = np.log(np.expm1(np.full((H,), 0.01, np.float32)))
        p["conv_w"] = normal_np(rng, (self.conv_k, self.d_conv_in),
                                1.0 / np.sqrt(self.conv_k))
        p["conv_b"] = np.zeros((self.d_conv_in,), np.float32)
        p["norm_g"] = np.ones((self.d_inner,), np.float32)
        return p

    def _split_proj(self, zxbcdt: torch.Tensor):
        """-> (z, xBC, dt) along the last axis."""
        di = self.d_inner
        return (zxbcdt[..., :di], zxbcdt[..., di:di + self.d_conv_in],
                zxbcdt[..., di + self.d_conv_in:])

    def _xbc(self, xbc: torch.Tensor):
        """(B, L, d_conv_in) -> x (B, L, H, P), B, C (B, L, H, ds): the
        G groups' B and C, each group's repeated over its H / G heads
        (copies: the scan reads the same values); one group stays (B,
        L, 1, ds) and broadcasts over the heads."""
        di, ds, G = self.d_inner, self.d_state, self.n_groups
        B, L = xbc.shape[:2]
        H = self.n_heads

        def groups(v):
            v = v.reshape(B, L, G, ds)
            return v if G == 1 else v.repeat_interleave(H // G, dim=2)

        return (xbc[..., :di].reshape(B, L, H, self.head_dim),
                groups(xbc[..., di:di + G * ds]),
                groups(xbc[..., di + G * ds:di + 2 * G * ds]))

    @staticmethod
    def _gated_norm(y: torch.Tensor, gate: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
        """-> (y gate, norm(y gate) g): the product in y's dtype, the
        norm in float32 (the mean of the squares and rsqrt as the
        reference's lowering computes them), returned in y's dtype."""
        gated = y * gate
        gf = gated.to(torch.float32)
        var = window_sum(gf * gf) * (1.0 / gated.shape[-1])
        r = rsqrt_f32(var + 1e-6)
        return gated, ((gf * r[..., None]) * g).to(y.dtype)

    # -- float forward ------------------------------------------------------
    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", cache: Optional[dict] = None, *,
                    rep: Rep = Rep.FP):
        """FullPrecision (or, with ``rep=Rep.FQ``, FakeQuantized)
        forward of (B, L, d) float -> (out in x's dtype, new cache or
        None), observing the reference's ranges under
        ``{scope}{name}.``; the scan in float32 (the conv's taps lift
        the input), the gate product in x's dtype, the gated norm in
        float32 and back."""
        subs = self._sub()
        nm = f"{scope}{self.name}"
        zxbcdt = subs["in_proj"].apply(p["in_proj"], x, rep)
        z, xbc, dt_r = self._split_proj(zxbcdt)
        if cache is not None:
            conv_in = torch.cat([cache["conv"], xbc], dim=1)
            xbcc = _causal_conv1d_fp(conv_in, p["conv_w"],
                                     p["conv_b"])[:, -xbc.shape[1]:]
            new_conv = conv_in[:, -(self.conv_k - 1):]
        else:
            xbcc = _causal_conv1d_fp(xbc, p["conv_w"], p["conv_b"])
            new_conv = xbc[:, -(self.conv_k - 1):]
        xbca = act_fn(ActKind.SILU, xbcc)
        if calib is not None:
            calib.observe(f"{nm}.conv.pre", xbcc)
            calib.observe(f"{nm}.conv", xbca)
        xh, bm, cm = (v.to(torch.float32) for v in self._xbc(xbca))
        dt = softplus_f32(dt_r.to(torch.float32) + p["dt_bias"])
        A = -exp_f32(p["A_log"])
        y, h_last = ssm2_core(xh, dt, bm.contiguous(), cm.contiguous(), A,
                              p["D"], None if cache is None else cache["h"])
        y = y.reshape(x.shape[0], x.shape[1], self.d_inner).to(x.dtype)
        gated, yn = self._gated_norm(y, act_fn(ActKind.SILU, z),
                                     p["norm_g"])
        if calib is not None:
            calib.observe(f"{nm}.y", y)
            calib.observe(f"{nm}.z.pre", z)
            calib.observe(f"{nm}.gated", gated)
            calib.observe(f"{nm}.norm", yn)
        out = subs["out_proj"].apply(p["out_proj"], yn, rep)
        new_cache = ({"conv": new_conv, "h": h_last}
                     if cache is not None else None)
        return out, new_cache

    # -- transform ------------------------------------------------------------
    def deploy(self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float,
               zp_x: int) -> Tuple[dict, np.ndarray]:
        """-> (integer and island tables, eps of out_proj's
        accumulator): the reference's float64 host arithmetic."""
        subs = self._sub()
        nm = f"{scope}{self.name}"
        t: dict = {}
        ip, eps_acc = subs["in_proj"].deploy(p_np["in_proj"], eps_x, zp_x)
        t["in_proj"] = ip
        act_p = QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.xz")
        tp, eps_p, _ = act_p.deploy(ctx, scope, eps_acc, 0,
                                    subs["in_proj"].acc_bound())
        t["p_rqt"] = tp["rqt"]
        # conv over xBC
        w = np.asarray(p_np["conv_w"], np.float64)
        eps_cw = 2.0 * max(float(np.abs(w).max()), 1e-8) / 255.0
        t["conv_wq"] = np.clip(np.floor(w / eps_cw), -128,
                               127).astype(np.int8)
        eps_cacc = eps_cw * eps_p
        t["conv_bq"] = np.round(np.asarray(p_np["conv_b"], np.float64)
                                / eps_cacc).astype(np.int32)
        lo, hi = ctx.range(f"{nm}.conv.pre", "ssm")
        eps_cpre = 2.0 * max(abs(lo), abs(hi), 1e-6) / 255.0
        t["conv_rqt"] = make_rqt(
            eps_cacc, eps_cpre, zp_out=0, requant_factor=ctx.factor,
            acc_bound=self.conv_k * 127.0 * 127.0)
        lo_c, hi_c = ctx.range(f"{nm}.conv", "act_asym")
        eps_conv = (max(hi_c, lo_c + 1e-6) - lo_c) / 255.0
        zp_conv = ACT_QMIN - int(round(lo_c / eps_conv))
        t["conv_lut"] = build_lut(lambda v: act_fn_np(ActKind.SILU, v),
                                  eps_cpre, 0, eps_conv, zp_conv)
        # island constants
        t["A"] = -np.exp(np.asarray(p_np["A_log"], np.float32))
        t["Dv"] = np.asarray(p_np["D"], np.float32)
        t["dt_bias"] = np.asarray(p_np["dt_bias"], np.float32)
        t["eps_p_f"] = np.float32(eps_p)
        t["eps_conv_f"] = np.float32(eps_conv)
        t["zp_conv_f"] = np.float32(zp_conv)
        # the gated RMS norm runs inside the island; its exit quantizes
        # the norm's output
        t["norm_g_f"] = np.asarray(p_np["norm_g"], np.float32)
        lo_n, hi_n = ctx.range(f"{nm}.norm", "norm")
        eps_n = 2.0 * max(abs(lo_n), abs(hi_n), 1e-6) / 255.0
        t["eps_n_inv"] = np.float32(1.0 / eps_n)
        ipo, eps_acco = subs["out_proj"].deploy(p_np["out_proj"], eps_n, 0)
        t["out_proj"] = ipo
        return t, eps_acco

    # -- integer path ---------------------------------------------------------
    def island(self, t: dict, s_z: torch.Tensor, s_conv: torch.Tensor,
               s_dt: torch.Tensor, h0: Optional[torch.Tensor]):
        """The float island: dt = softplus(s_dt eps_p + dt_bias) (one
        fused multiply-add), x, B, C dequantized, the scan, the gate
        z / (1 + e^-z), the gated RMS norm, quantized to int8 by
        `eps_n_inv`.  -> (s_n (B, L, d_inner) int8, h_last float32)."""
        f32 = torch.float32
        dt = softplus_f32(fma(s_dt.to(f32), t["eps_p_f"], t["dt_bias"]))
        xbc = (s_conv.to(f32) - t["zp_conv_f"]) * t["eps_conv_f"]
        xh, bm, cm = self._xbc(xbc)
        y, h_last = ssm2_core(xh, dt, bm, cm, t["A"], t["Dv"], h0)
        y = y.reshape(s_z.shape)
        zf = s_z.to(f32) * t["eps_p_f"]
        gate = zf / (1.0 + exp_f32(-zf))
        _, yn = self._gated_norm(y, gate, t["norm_g_f"])
        s_n = torch.clamp(torch.round(yn * t["eps_n_inv"]), -128, 127)
        return s_n.to(torch.int8), h_last

    def apply_id(self, t: dict, s_x: torch.Tensor,
                 cache: Optional[dict] = None):
        """s_x (B, L, d) int8 -> (out_proj's int32 accumulator (B, L,
        d), new cache or None)."""
        subs = self._sub()
        s_all = subs["in_proj"].apply_id(t["in_proj"], s_x, t["p_rqt"])
        s_z, s_xbc, s_dt = self._split_proj(s_all)
        K = self.conv_k
        if cache is not None:
            conv_in = torch.cat([cache["conv"], s_xbc], dim=1)
        else:
            conv_in = F.pad(s_xbc, (0, 0, K - 1, 0))
        new_conv = conv_in[:, -(K - 1):]
        c_acc = causal_conv1d_int(conv_in, t["conv_wq"], t["conv_bq"])
        s_cpre = requant(c_acc, t["conv_rqt"])
        s_conv = requant_act(s_cpre, {"lut": t["conv_lut"]})  # asym int8
        s_n, h_last = self.island(t, s_z, s_conv, s_dt,
                                  cache["h"] if cache is not None else None)
        out = subs["out_proj"].apply_id(t["out_proj"], s_n)
        new_cache = ({"conv": new_conv, "h": h_last}
                     if cache is not None else None)
        return out, new_cache

    def init_cache(self, B: int, device="cuda", rep: Rep = Rep.ID,
                   dtype=None) -> dict:
        """A zeroed cache of B rows: the conv window over x, B, C (int8
        at Rep.ID, else `dtype`, bfloat16 by default) and the float32
        scan state at every rep."""
        return {
            "conv": torch.zeros((B, self.conv_k - 1, self.d_conv_in),
                                dtype=_conv_dtype(rep, dtype),
                                device=device),
            "h": torch.zeros((B, self.n_heads, self.head_dim, self.d_state),
                             dtype=torch.float32, device=device),
        }


def _conv_dtype(rep: Rep, dtype) -> torch.dtype:
    """The conv window's dtype: int8 images at Rep.ID, the float
    forward's `dtype` (bfloat16 by default) otherwise."""
    if rep is Rep.ID:
        return torch.int8
    return dtype or torch.bfloat16


def load_core(t: dict) -> dict:
    """A `QMamba1`'s torch tables -> the serving state `apply_id`
    reads (a `QMamba2`'s are that already): dt_proj's weight padded
    with zero rows to a multiple of K_ALIGN along K (the GEMM kernel's
    granule; `apply_id` pads its input to match), the stored (N, K)
    layout kept."""
    if "dt_proj" not in t:
        return t
    w = t["dt_proj"]["w_q"]
    k = w.shape[0]
    kp = -(-k // K_ALIGN) * K_ALIGN
    if kp == k:
        return t
    wt = torch.zeros((w.shape[1], kp), dtype=w.dtype, device=w.device)
    wt[:, :k] = w.t()
    return {**t, "dt_proj": {**t["dt_proj"], "w_q": wt.t()}}


def _dt_proj(ip: dict, s_dtr: torch.Tensor, di: int) -> torch.Tensor:
    """dt_proj's int32 accumulator over the (padded) rank columns."""
    kp = ip["w_q"].shape[0]
    return QLinear(kp, di, use_bias=True).apply_id(ip, s_dtr)
