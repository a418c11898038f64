"""Mixture-of-Experts with index-based dispatch (port of
`repro.layers.moe.QMoE`: `init_np`, the float forward `apply_float`,
`deploy` and `apply_id`).

Tokens are taken in groups of `group_size` (`_group`); each group routes
its tokens to `top_k` of `n_experts` experts, at most `capacity(gs)`
tokens an expert (earlier tokens win), by the one-hot cumsum and a
scatter with drop into a (G, E, C) token-for-slot table whose empty
slots hold the sentinel Gs (a zero row).  A capacity-dropped token
loses that expert's contribution.

Integer path:

    s_x --router GEMM--> int32 (G, Gs, E) --float island--> s_gates
        int8 (round(127 g)), experts, slots
    s_x gathered (G, E, C, d)
        --grouped gate GEMM + g_rqt epilogue--> int8 --+
        --grouped up GEMM + u_rqt epilogue----> int8 --+-- requant_gate
              (the SiLU LUT, (s_g - zp_g) * s_u, h_rqt) --> s_h int8
        --grouped down GEMM + o_rqt epilogue--> s_o int8 (G, E, C, d)
    acc = sum_k s_o[e_k, slot_k] * s_gates_k      int32 (T, d), eps_comb

The three expert GEMMs are one launch each over all G x E groups
(`kernels.int8_matmul_grouped`); their requant tables are per (expert,
channel) with shifts shared across experts.  Everything else (routing,
gathers, the combine) is plain torch on the device, as the reference's
is plain jnp.

The routing island is written so that the card and the CPU give the same
bits: logits are r_acc * router_scale in float32; the softmax takes the
row max, `island_exp` (the paged attention's exp, one rounded float32
operation a step), a sum over the experts in `_lane_sum`'s fixed order
and one IEEE divide; top-k is a stable descending sort (ties to the lower
expert index, as `jax.lax.top_k`'s); the k gates are normalized by a
fixed-order sum floored at 1e-9.  The reference leaves the softmax's exp
and sums to XLA, so bit equality with it is not built in: the tests count
the gate images and expert picks that differ (none so far).

Capacity routing couples the tokens of a group: a serving dispatch's
parked rows (token 0 at INACTIVE_POS) route and compete for capacity as
the reference's do.

FakeQuantized (`apply_float(..., Rep.FQ, qs=init_qstate())`): the
router on PACT-restricted weights, each expert weight on its own
per-(expert, out-channel) floor grid with the straight-through mask
(`_fq_w3`), the gate's activation clipped by `pact_act_asymm` with the
layer's (alpha, beta); the float forward returns the Switch-style
load-balancing `aux_loss` beside y at FP and FQ, as the reference's
does.  The float forward's softmax (routing and `aux_loss`) is
`core.island.softmax_f32`, `jax.nn.softmax` as the reference's lowering
computes it; the ID path keeps the serving island's.  The router's
gradient flows through that softmax (its backward p (g - sum p g)), the
top-k gates, their normalisation and the capacity mask; expert and slot
indices carry none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.intmath import build_lut
from repro_torch.core.island import softmax_f32, window_sum
from repro_torch.core.pact import pact_act_asymm
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.int8_matmul import int8_matmul_grouped
from repro_torch.kernels.paged_attention import _lane_sum, island_exp
from repro_torch.kernels.requant_kernel import requant_gate
from repro_torch.layers.common import (
    ACT_QMIN, ActKind, DeployCtx, act_fn, act_fn_np, float_matmul, normal_np,
    run_blocks,
)
from repro_torch.layers.linear import QLinear

EPS_GATE = 1.0 / 127.0
EXPERT_WEIGHTS = ("wg_q", "wu_q", "wd_q")  # (E, K, N), stored (E, N, K)


@dataclasses.dataclass(frozen=True)
class QMoE:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    group_size: int = 512
    capacity_factor: float = 1.25
    act: ActKind = ActKind.SILU
    normalize_gates: bool = True
    name: str = "moe"

    def _router(self) -> QLinear:
        return QLinear(self.d_model, self.n_experts)

    def capacity(self, gs: int) -> int:
        c = int(math.ceil(
            self.top_k * self.capacity_factor * gs / self.n_experts))
        return max(4, int(math.ceil(c / 4) * 4))

    # -- init (host, numpy) ------------------------------------------------
    def init_np(self, rng: np.random.Generator) -> dict:
        """Float params with the reference's shapes and scales."""
        E, d, f = self.n_experts, self.d_model, self.d_ff
        return {
            "router": self._router().init_np(rng),
            "wg": normal_np(rng, (E, d, f), 1.0 / np.sqrt(d)),
            "wu": normal_np(rng, (E, d, f), 1.0 / np.sqrt(d)),
            "wd": normal_np(rng, (E, f, d), 1.0 / np.sqrt(f)),
        }

    # -- routing -----------------------------------------------------------
    def _group(self, x: torch.Tensor):
        T = x.shape[0]
        gs = min(self.group_size, T)
        if T % gs:
            raise ValueError(
                f"{T} tokens do not split into MoE groups of {gs} (the "
                f"reference asserts T % gs == 0: {(T, gs)})")
        return x.reshape(T // gs, gs, -1), gs

    def _route(self, logits: torch.Tensor, softmax=None):
        """logits (G, Gs, E) float32 -> gates (G, Gs, k) float32 (0 where
        capacity dropped), experts (G, Gs, k) int64, slot positions (G,
        Gs, k) int64, token-for-slot (G, E, C) int64 (Gs: empty), C.
        The softmax is the serving island's (`island_softmax`) unless
        the caller names another."""
        G, Gs, E = logits.shape
        k = self.top_k
        C = self.capacity(Gs)
        dev = logits.device
        probs = (softmax or island_softmax)(logits)
        srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = srt[..., :k], idx[..., :k]
        if self.normalize_gates:
            gates = gates / torch.clamp(_lane_sum(gates), min=1e-9)
        # slotting, token-major so earlier tokens win capacity
        e_flat = experts.reshape(G, Gs * k)
        oh = torch.nn.functional.one_hot(e_flat, E).to(torch.int32)
        pos_all = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1
        pos = torch.gather(pos_all, 2, e_flat[..., None])[..., 0].to(
            torch.int64)
        keep = pos < C
        tok = torch.arange(Gs, device=dev).repeat_interleave(k).expand(
            G, Gs * k)
        tfs = torch.full((G, E * C + 1), Gs, dtype=torch.int64, device=dev)
        # dropped entries all land on the extra column, cut off below
        tfs.scatter_(1, torch.where(keep, e_flat * C + pos, E * C), tok)
        tfs = tfs[:, :E * C].reshape(G, E, C)
        keep = keep.reshape(G, Gs, k)
        gates = gates * keep.to(gates.dtype)
        return gates, experts, pos.reshape(G, Gs, k), tfs, C

    @staticmethod
    def _gather_tokens(x_pad: torch.Tensor, tfs: torch.Tensor):
        """x_pad (G, Gs + 1, d); tfs (G, E, C) -> (G, E, C, d)."""
        g = torch.arange(x_pad.shape[0], device=x_pad.device)[:, None, None]
        return x_pad[g, tfs]

    @staticmethod
    def _combine(he_pad: torch.Tensor, experts: torch.Tensor,
                 pos: torch.Tensor):
        """he_pad (G, E, C + 1, f); experts, pos (G, Gs, k) -> (G, Gs,
        k, f)."""
        g = torch.arange(he_pad.shape[0], device=he_pad.device)[:, None,
                                                                None]
        return he_pad[g, experts, pos]

    def init_qstate(self, device="cuda") -> dict:
        """The gate activation's PACT clips [alpha, beta) = [-1, 6)."""
        return {"alpha": torch.tensor(-1.0, dtype=torch.float32,
                                      device=device),
                "beta": torch.tensor(6.0, dtype=torch.float32,
                                     device=device)}

    def aux_loss(self, logits: torch.Tensor,
                 experts: torch.Tensor) -> torch.Tensor:
        """Switch-style load balance, logits (G, Gs, E) float32 and the
        chosen experts (G, Gs, k): E * mean over groups of sum_e (mean
        probability of e) * (share of the k choices that pick e)."""
        G, Gs, E = logits.shape
        # every mean a sum in the reference lowering's order, then / n
        me = window_sum(softmax_f32(logits).transpose(1, 2)) / Gs  # (G, E)
        oh = torch.nn.functional.one_hot(experts, E).to(torch.float32)
        ce = torch.sum(oh, dim=(1, 2)) / Gs / self.top_k   # exact sums
        return E * (window_sum(window_sum(me * ce)) / G)

    # -- float forward (FullPrecision and FakeQuantized, torch) --------------
    def apply_float(self, p: dict, x: torch.Tensor, rep: Rep = Rep.FP, *,
                    qs=None, calib=None, scope: str = ""):
        """x (T, d) float -> (y (T, d) in x's dtype, aux_loss float32),
        observing the five expert activation spaces under `scope`
        (padded slots included, as the reference observes them).  At FQ
        the router and expert weights are restricted to their grids and
        the gate's activation clipped by ``qs`` (`init_qstate`)."""
        def w3(name):
            w = p[name]
            if rep is Rep.FQ:
                beta = torch.clamp(torch.amax(torch.abs(w.detach()), dim=1),
                                   min=1e-8)
                return _fq_w3(w, beta)
            return w

        xg, _ = self._group(x)
        logits = self._router().apply(p["router"], xg, rep).to(torch.float32)
        gates, experts, pos, tfs, C = self._route(logits, softmax_f32)
        x_pad = torch.cat([xg, torch.zeros_like(xg[:, :1])], dim=1)
        xe = self._gather_tokens(x_pad, tfs)            # (G, E, C, d)
        g = float_matmul(xe, w3("wg").to(x.dtype))
        u = float_matmul(xe, w3("wu").to(x.dtype))
        ga = act_fn(self.act, g)
        if rep is Rep.FQ and qs is not None:
            ga = pact_act_asymm(ga, qs["alpha"], qs["beta"], 8)
        h = ga * u
        he = float_matmul(h, w3("wd").to(x.dtype))
        if calib is not None:
            calib.observe(f"{scope}{self.name}.gate.pre", g)
            calib.observe(f"{scope}{self.name}.gate", act_fn(self.act, g))
            calib.observe(f"{scope}{self.name}.up", u)
            calib.observe(f"{scope}{self.name}.h", h)
            calib.observe(f"{scope}{self.name}.out", he)
        he_pad = torch.cat([he, torch.zeros_like(he[:, :, :1])], dim=2)
        pos_safe = torch.where(gates > 0, pos, C)
        yk = self._combine(he_pad, experts, pos_safe)    # (G, Gs, k, d)
        y = torch.sum(yk * gates[..., None].to(x.dtype), dim=2)
        return y.reshape(x.shape), self.aux_loss(logits, experts)

    # -- deploy (host, numpy) ----------------------------------------------
    @staticmethod
    def _quant_expert(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(expert, out-channel) symmetric int8, rounding to nearest
        (the reference's float64 arithmetic), one expert at a time on
        threads.  w (E, K, N) -> (q (E, K, N) int8, eps_w (E, N))."""
        E, K, N = w.shape
        q = np.empty((E, K, N), np.int8)
        eps = np.empty((E, N), np.float64)

        def one(e):
            we = np.asarray(w[e], np.float64)
            amax = np.maximum(np.abs(we).max(axis=0), 1e-8)
            eps[e] = 2.0 * amax / 255.0
            q[e] = np.clip(np.round(we / eps[e][None, :]), -128, 127)

        run_blocks(one, [(e,) for e in range(E)])
        return q, eps

    def deploy(self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float,
               zp_x: int) -> Tuple[dict, np.ndarray]:
        """-> (tables, [eps_comb]): the reference's tables leaf for leaf."""
        t: dict = {}
        ip_r, eps_acc_r = self._router().deploy(p_np["router"], eps_x, zp_x)
        t["router"] = ip_r
        t["router_scale"] = eps_acc_r.astype(np.float32)
        d, f = self.d_model, self.d_ff
        wg_q, eps_wg = self._quant_expert(p_np["wg"])
        wu_q, eps_wu = self._quant_expert(p_np["wu"])
        lo, hi = ctx.range(f"{scope}{self.name}.gate.pre", "attn")
        eps_pre = 2.0 * max(abs(lo), abs(hi), 1e-6) / 255.0
        t["g_rqt"] = make_rqt(eps_wg * eps_x, eps_pre, zp_out=0,
                              requant_factor=ctx.factor,
                              acc_bound=d * 127.0 * 127.0)
        lo_g, hi_g = ctx.range(f"{scope}{self.name}.gate", "act_asym")
        eps_gact = (max(hi_g, lo_g + 1e-6) - lo_g) / 255.0
        zp_g = ACT_QMIN - int(round(lo_g / eps_gact))
        t["g_lut"] = build_lut(lambda v: act_fn_np(self.act, v), eps_pre, 0,
                               eps_gact, zp_g)
        lo_u, hi_u = ctx.range(f"{scope}{self.name}.up", "attn")
        eps_u = 2.0 * max(abs(lo_u), abs(hi_u), 1e-6) / 255.0
        t["u_rqt"] = make_rqt(eps_wu * eps_x, eps_u, zp_out=0,
                              requant_factor=ctx.factor,
                              acc_bound=d * 127.0 * 127.0)
        lo_h, hi_h = ctx.range(f"{scope}{self.name}.h", "attn")
        eps_h = 2.0 * max(abs(lo_h), abs(hi_h), 1e-6) / 255.0
        t["h_rqt"] = make_rqt(eps_gact * eps_u, eps_h, zp_out=0,
                              requant_factor=ctx.factor,
                              acc_bound=float(256 * 128))
        wd_q, eps_wd = self._quant_expert(p_np["wd"])
        t.update({"wg_q": wg_q, "wu_q": wu_q, "wd_q": wd_q,
                  "zp_g": np.int32(zp_g)})
        lo_o, hi_o = ctx.range(f"{scope}{self.name}.out", "resid")
        eps_o = 2.0 * max(abs(lo_o), abs(hi_o), 1e-6) / 255.0
        t["o_rqt"] = make_rqt(eps_wd * eps_h, eps_o, zp_out=0,
                              requant_factor=ctx.factor,
                              acc_bound=f * 127.0 * 127.0)
        return t, np.asarray([EPS_GATE * eps_o])

    # -- integer path (torch) ----------------------------------------------
    def route_id(self, t: dict, xg: torch.Tensor):
        """The router GEMM and the float island on grouped int8 tokens
        xg (G, Gs, d) -> (s_gates int8, experts, pos, tfs, C)."""
        r_acc = self._router().apply_id(t["router"], xg)
        logits = r_acc.to(torch.float32) * t["router_scale"]
        gates, experts, pos, tfs, C = self._route(logits)
        s_gates = torch.round(gates * 127.0).to(torch.int8)
        return s_gates, experts, pos, tfs, C

    def apply_id(self, t: dict, s_x: torch.Tensor) -> torch.Tensor:
        """s_x (T, d) int8 -> int32 accumulator (T, d) in eps_comb
        units."""
        xg, _ = self._group(s_x)
        s_gates, experts, pos, tfs, C = self.route_id(t, xg)
        x_pad = torch.cat([xg, torch.zeros_like(xg[:, :1])], dim=1)
        xe = self._gather_tokens(x_pad, tfs)            # (G, E, C, d)
        s_pre = int8_matmul_grouped(xe, t["wg_q"], t["g_rqt"])
        s_u = int8_matmul_grouped(xe, t["wu_q"], t["u_rqt"])
        s_h = requant_gate(s_pre, s_u, t["g_lut"], t["zp_g"], t["h_rqt"])
        s_o = int8_matmul_grouped(s_h, t["wd_q"], t["o_rqt"])
        o_pad = torch.cat([s_o, torch.zeros_like(s_o[:, :, :1])], dim=2)
        pos_safe = torch.where(s_gates > 0, pos, C)
        yk = self._combine(o_pad, experts, pos_safe)     # (G, Gs, k, d)
        acc = torch.sum(yk.to(torch.int32) * s_gates[..., None].to(
            torch.int32), dim=2, dtype=torch.int32)
        return acc.reshape(s_x.shape[0], -1)


def island_softmax(logits: torch.Tensor) -> torch.Tensor:
    """The ID routing island's softmax over the last axis of float32
    logits, the same bits on every device: the row max, `island_exp`
    (the paged attention's exp), the sum in `_lane_sum`'s fixed order
    and one IEEE divide."""
    m = logits.amax(dim=-1, keepdim=True)
    p = island_exp(logits - m)
    return p / _lane_sum(p)


def _fq_w3(w: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The FQ restriction of (E, d_in, out) expert weights, beta (E,
    out): the value is the paper's symmetric floor grid, eps = 2 b /
    255; the gradient the chi_[-b, b) straight-through mask, written as
    the reference writes it, stop_gradient(q - mask w) + mask w (the
    same float32 bits)."""
    b = beta[:, None, :]
    eps = 2.0 * b / torch.full((), 255.0, dtype=b.dtype, device=b.device)
    q = torch.clamp(torch.floor(w / eps), -128.0, 127.0) * eps
    mask = ((w >= -b) & (w < b)).to(w.dtype)
    return (q - mask * w).detach() + mask * w
