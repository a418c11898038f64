"""The decoder blocks (port of `repro.models.blocks.DenseBlock`,
`MambaBlock` and `SharedAttnBlock`: `init_qstate`, the float forward
`apply_float` at FullPrecision and FakeQuantized, `deploy` and
`apply_id`).

Every block's `apply_float(p, x, ..., rep=, qs=, aux=)` returns the
block's output; a block with experts appends its MoE's load-balancing
loss (a float32 0-d tensor) to the list ``aux`` when the caller passes
one (the reference returns it beside x; the others append nothing, as
the reference's return None).

norm1 -> attention -> add1 -> norm2 -> MLP (or MoE) -> add2.  With
`n_experts > 0` a `QMoE` replaces the MLP over the block's B * S
tokens, and its int32 combine accumulator goes into the second `QAdd`.
With `shared_expert` (llama4_maverick) a gated `QMLP` named
"shared_mlp" runs beside the MoE on the same normed input (scope
``sh.``, params and tables under "mlp"); the float forward adds its
output to the MoE's, and the integer path requantizes its int32
accumulator into the MoE's combine space (`sh_rqt`, int32 out within
+-2^24) and adds it to the combine accumulator.  The block's FQ
clips are its MLP's, or its MoE's gate clips (and the shared MLP's
beside them).  In the ID path
the residual stream is a symmetric int8 image between blocks; in the
float forward it is float32, and each sublayer observes its output
under the block's scope (the names `deploy` reads back).

`MambaBlock` is norm -> `layers.ssm.QMamba1` (or `QMamba2`) -> add;
its cache is the layer's {"conv", "h"} state, which `apply_id` advances
in place.

Every block's float forward takes the reference's float cache
(`cache=`, `pos=`; `init_cache` gives the zeroed one): the attention
blocks write their K/V rows into it in place, the Mamba block replaces
the dict's {"conv", "h"} with the new state.

`SharedAttnBlock` is zamba2's shared attention: norm over concat(x,
x0) (2 d wide) -> attention -> add, with no MLP.  Its float weights
are one set for every application; `deploy` gives each application
its own integer tables, the concat's two halves brought into one
symmetric space (`cat_rqt_x`, `cat_rqt_x0`) from the residual's
quantum and x0's, the embedding's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rep import Rep
from repro_torch.layers.add import QAdd
from repro_torch.layers.attention import QAttention
from repro_torch.layers.common import ActKind, DeployCtx
from repro_torch.layers.mlp import QMLP
from repro_torch.layers.moe import QMoE
from repro_torch.layers.norms import QNorm
from repro_torch.layers.ssm import QMamba1, QMamba2
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import requant

SHARED_RANGE = 1 << 24  # the shared expert's requantized int32 range


@dataclasses.dataclass(frozen=True)
class DenseBlock:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    act: ActKind = ActKind.SILU
    gated: bool = True
    norm: str = "rms"
    norm_bias: bool = False
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    max_seq: int = 4096
    # MoE (n_experts > 0 replaces the MLP)
    n_experts: int = 0
    top_k: int = 1
    moe_group: int = 512
    shared_expert: bool = False

    @property
    def shared(self) -> bool:
        """Whether a shared expert runs beside the MoE (the reference
        reads `shared_expert` only in a block with experts)."""
        return self.shared_expert and self.n_experts > 0

    @property
    def ffn(self) -> str:
        """The sublayer after norm2: "moe" or "mlp"."""
        return "moe" if self.n_experts > 0 else "mlp"

    @property
    def ffns(self) -> Tuple[str, ...]:
        """The sublayers after norm2 that own params and clips: ("mlp",),
        ("moe",) or, with the shared expert, ("moe", "mlp")."""
        return (self.ffn, "mlp") if self.shared else (self.ffn,)

    def _subs(self):
        ffn = (QMoE(self.d_model, self.d_ff, self.n_experts, self.top_k,
                    group_size=self.moe_group, act=self.act)
               if self.n_experts > 0 else
               QMLP(self.d_model, self.d_ff, act=self.act, gated=self.gated))
        s = {
            "norm1": QNorm(self.d_model, kind=self.norm,
                           use_bias=self.norm_bias, name="norm1"),
            "attn": QAttention(
                self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                rope_base=self.rope_base, rope_fraction=self.rope_fraction,
                max_seq=self.max_seq),
            "add1": QAdd(name="add1"),
            "norm2": QNorm(self.d_model, kind=self.norm,
                           use_bias=self.norm_bias, name="norm2"),
            self.ffn: ffn,
            "add2": QAdd(name="add2"),
        }
        if self.shared:
            s["mlp"] = QMLP(self.d_model, self.d_ff, act=self.act,
                            gated=self.gated, name="shared_mlp")
        return s

    def init_np(self, rng: np.random.Generator) -> dict:
        subs = self._subs()
        p = {
            "norm1": subs["norm1"].init_np(),
            "attn": subs["attn"].init_np(rng),
            "norm2": subs["norm2"].init_np(),
        }
        for n in self.ffns:
            p[n] = subs[n].init_np(rng)
        return p

    def init_qstate(self, device="cuda") -> dict:
        """The block's FQ clips: {"mlp": `QMLP.init_qstate`} or {"moe":
        `QMoE.init_qstate`}, and the shared MLP's beside the MoE's."""
        subs = self._subs()
        return {n: subs[n].init_qstate(device) for n in self.ffns}

    def _ffn_float(self, sub, p, h, calib, scope, rep, qs, aux):
        qs = (qs or {}).get(self.ffn)
        if self.n_experts == 0:
            return sub.apply_float(p, h, calib, scope, rep=rep, qs=qs)
        B, S, D = h.shape
        m, a = sub.apply_float(p, h.reshape(B * S, D), rep, qs=qs,
                               calib=calib, scope=scope)
        if aux is not None:
            aux.append(a)
        return m.reshape(B, S, D)

    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", *, rep: Rep = Rep.FP, qs=None,
                    aux: Optional[list] = None, cache: Optional[dict] = None,
                    pos=None) -> torch.Tensor:
        """FullPrecision (or, with ``rep=Rep.FQ`` and the block's clips
        ``qs``, FakeQuantized) forward of one block; the residual stream
        stays in x's dtype; the MoE's aux loss goes to ``aux``; with a
        float `cache` the attention writes it in place at `pos`
        (`QAttention.apply_float`)."""
        subs = self._subs()
        h = subs["norm1"].apply_fp(p["norm1"], x, calib, scope + "n1.")
        a = subs["attn"].apply_float(p["attn"], h, calib, scope, rep=rep,
                                     cache=cache, pos=pos)
        x = subs["add1"].apply_fp(x, a, calib, scope)
        h = subs["norm2"].apply_fp(p["norm2"], x, calib, scope + "n2.")
        m = self._ffn_float(subs[self.ffn], p[self.ffn], h, calib, scope,
                            rep, qs, aux)
        if self.shared:
            m = m + subs["mlp"].apply_float(
                p["mlp"], h, calib, scope + "sh.", rep=rep,
                qs=(qs or {}).get("mlp"))
        return subs["add2"].apply_fp(x, m, calib, scope)

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_in: float
    ) -> Tuple[dict, float]:
        subs = self._subs()
        t: dict = {}
        t["norm1"], eps_n1, _ = subs["norm1"].deploy(
            ctx, scope + "n1.", p_np["norm1"], eps_in)
        t["attn"], eps_attn_acc = subs["attn"].deploy(
            ctx, scope, p_np["attn"], eps_n1, 0)
        t["add1"], eps_r1, _ = subs["add1"].deploy(
            ctx, scope, eps_in, 0, eps_attn_acc, 0)
        t["norm2"], eps_n2, _ = subs["norm2"].deploy(
            ctx, scope + "n2.", p_np["norm2"], eps_r1)
        t[self.ffn], eps_m_acc = subs[self.ffn].deploy(
            ctx, scope, p_np[self.ffn], eps_n2, 0)
        if self.shared:
            t["mlp"], eps_sh_acc = subs["mlp"].deploy(
                ctx, scope + "sh.", p_np["mlp"], eps_n2, 0)
            # the shared accumulator requantized into the MoE's combine
            # space, int32 within +-2^24 (raises where unschedulable)
            t["sh_rqt"] = make_rqt(
                eps_sh_acc, float(eps_m_acc[0]), zp_out=0,
                qmin=-SHARED_RANGE, qmax=SHARED_RANGE,
                requant_factor=ctx.factor,
                acc_bound=subs["mlp"].d_ff * 127.0 * 127.0)
        t["add2"], eps_r2, _ = subs["add2"].deploy(
            ctx, scope, eps_r1, 0, eps_m_acc, 0)
        return t, eps_r2

    def apply_id(self, t: dict, s_x: torch.Tensor, cache: dict,
                 pos: torch.Tensor) -> torch.Tensor:
        """s_x (B, S, d) int8 -> (B, S, d) int8; writes this layer's
        K/V columns into `cache` in place."""
        subs = self._subs()
        h = subs["norm1"].apply_id(t["norm1"], s_x)
        a_acc = subs["attn"].apply_id(t["attn"], h, cache, pos)
        s_r = subs["add1"].apply_id(t["add1"], s_x, a_acc)
        h = subs["norm2"].apply_id(t["norm2"], s_r)
        if self.n_experts > 0:
            B, S, D = h.shape
            m_acc = subs["moe"].apply_id(t["moe"], h.reshape(B * S, D))
            m_acc = m_acc.reshape(B, S, D)
            if self.shared:
                sh_acc = subs["mlp"].apply_id(t["mlp"], h)
                m_acc = m_acc + requant(
                    sh_acc, t["sh_rqt"], qmin=-SHARED_RANGE,
                    qmax=SHARED_RANGE, out_dtype=torch.int32)
        else:
            m_acc = subs["mlp"].apply_id(t["mlp"], h)
        return subs["add2"].apply_id(t["add2"], s_r, m_acc)

    def init_cache(self, B: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        """The float forward's cache, the attention's (the ID cache is
        the model's pools)."""
        return self._subs()["attn"].init_cache(B, max_len, dtype, device)


@dataclasses.dataclass(frozen=True)
class MambaBlock:
    """norm -> mamba -> add (the pre-norm residual SSM block; port of
    `repro.models.blocks.MambaBlock`, Mamba-1 or Mamba-2 core)."""

    d_model: int
    ssm_kind: str = "mamba1"
    d_state: int = 16
    expand: int = 2
    head_dim: int = 64
    norm: str = "rms"

    def __post_init__(self):
        if self.ssm_kind not in ("mamba1", "mamba2"):
            raise ValueError(f"ssm_kind {self.ssm_kind!r}")

    def _subs(self):
        core = (QMamba1(self.d_model, d_state=self.d_state,
                        expand=self.expand)
                if self.ssm_kind == "mamba1" else
                QMamba2(self.d_model, d_state=self.d_state,
                        expand=self.expand, head_dim=self.head_dim))
        return {
            "norm": QNorm(self.d_model, kind=self.norm, name="norm"),
            "core": core,
            "add": QAdd(name="add"),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        subs = self._subs()
        return {"norm": subs["norm"].init_np(),
                "core": subs["core"].init_np(rng)}

    def init_qstate(self, device="cuda") -> dict:
        """No clips: the scan core's FQ forward quantizes its
        projections' weights only."""
        return {}

    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", *, rep: Rep = Rep.FP, qs=None,
                    aux: Optional[list] = None, cache: Optional[dict] = None,
                    pos=None) -> torch.Tensor:
        """FullPrecision (or FakeQuantized) forward of one block; no aux
        loss.  With a float `cache` ({"conv", "h"}) the core starts from
        it and the dict's entries are replaced by the new state (new
        tensors: the conv window may change dtype); `pos` is not read."""
        subs = self._subs()
        h = subs["norm"].apply_fp(p["norm"], x, calib, scope + "n.")
        y, new = subs["core"].apply_float(p["core"], h, calib, scope,
                                          cache, rep=rep)
        if cache is not None:
            cache.update(new)
        return subs["add"].apply_fp(x, y, calib, scope)

    def deploy(self, ctx: DeployCtx, scope: str, p_np: dict,
               eps_in: float) -> Tuple[dict, float]:
        subs = self._subs()
        t: dict = {}
        t["norm"], eps_n, _ = subs["norm"].deploy(ctx, scope + "n.",
                                                  p_np["norm"], eps_in)
        t["core"], eps_core_acc = subs["core"].deploy(
            ctx, scope, p_np["core"], eps_n, 0)
        t["add"], eps_out, _ = subs["add"].deploy(ctx, scope, eps_in, 0,
                                                  eps_core_acc, 0)
        return t, eps_out

    def apply_id(self, t: dict, s_x: torch.Tensor,
                 cache: dict) -> torch.Tensor:
        """s_x (B, S, d) int8 -> (B, S, d) int8; advances this layer's
        {"conv", "h"} state in `cache` in place."""
        subs = self._subs()
        h = subs["norm"].apply_id(t["norm"], s_x)
        acc, new = subs["core"].apply_id(t["core"], h, cache)
        cache["conv"].copy_(new["conv"])
        cache["h"].copy_(new["h"])
        return subs["add"].apply_id(t["add"], s_x, acc)

    def init_cache(self, B: int, device="cuda", rep: Rep = Rep.ID,
                   dtype=None) -> dict:
        """The core's zeroed {"conv", "h"} of B rows (`rep` and `dtype`
        pick the conv window's dtype)."""
        return self._subs()["core"].init_cache(B, device, rep, dtype)


@dataclasses.dataclass(frozen=True)
class SharedAttnBlock:
    """zamba2's shared attention over concat(x, x0) (port of
    `repro.models.blocks.SharedAttnBlock`): one float weight set for
    every application, which the caller passes in."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    max_seq: int = 4096
    norm: str = "rms"

    def _subs(self):
        return {
            "norm": QNorm(2 * self.d_model, kind=self.norm, name="norm"),
            "attn": QAttention(self.d_model, self.n_heads, self.n_kv_heads,
                               self.head_dim, max_seq=self.max_seq,
                               d_in=2 * self.d_model),
            "add": QAdd(name="add"),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        subs = self._subs()
        return {"norm": subs["norm"].init_np(),
                "attn": subs["attn"].init_np(rng)}

    def init_qstate(self, device="cuda") -> dict:
        return {}

    def apply_float(self, p: dict, x: torch.Tensor, x0: torch.Tensor,
                    calib=None, scope: str = "", *, rep: Rep = Rep.FP,
                    qs=None, aux: Optional[list] = None,
                    cache: Optional[dict] = None, pos=None) -> torch.Tensor:
        """FullPrecision (or FakeQuantized: `QAttention`'s FQ path)
        forward of one application over norm(concat(x, x0)); no aux
        loss; a float `cache` is the application's own K/V, written in
        place at `pos`."""
        subs = self._subs()
        cat = torch.cat([x, x0], dim=-1)
        h = subs["norm"].apply_fp(p["norm"], cat, calib, scope + "n.")
        a = subs["attn"].apply_float(p["attn"], h, calib, scope, rep=rep,
                                     cache=cache, pos=pos)
        return subs["add"].apply_fp(x, a, calib, scope)

    def deploy(self, ctx: DeployCtx, scope: str, p_np: dict, eps_in: float,
               eps_x0: float) -> Tuple[dict, float]:
        """One application's tables; the concat's two halves requantized
        into the symmetric space of the larger quantum."""
        subs = self._subs()
        t: dict = {}
        eps_cat = max(eps_in, eps_x0)
        t["cat_rqt_x"] = make_rqt(eps_in, eps_cat, zp_out=0,
                                  requant_factor=ctx.factor, acc_bound=128.0)
        t["cat_rqt_x0"] = make_rqt(eps_x0, eps_cat, zp_out=0,
                                   requant_factor=ctx.factor,
                                   acc_bound=128.0)
        t["norm"], eps_n, _ = subs["norm"].deploy(ctx, scope + "n.",
                                                  p_np["norm"], eps_cat)
        t["attn"], eps_a_acc = subs["attn"].deploy(ctx, scope, p_np["attn"],
                                                   eps_n, 0)
        t["add"], eps_out, _ = subs["add"].deploy(ctx, scope, eps_in, 0,
                                                  eps_a_acc, 0)
        return t, eps_out

    def apply_id(self, t: dict, s_x: torch.Tensor, s_x0: torch.Tensor,
                 cache: dict, pos: torch.Tensor) -> torch.Tensor:
        """s_x, s_x0 (B, S, d) int8 -> (B, S, d) int8; writes this
        application's K/V columns into `cache` in place."""
        subs = self._subs()
        a_ = requant(s_x.to(torch.int32), t["cat_rqt_x"])
        b_ = requant(s_x0.to(torch.int32), t["cat_rqt_x0"])
        h = subs["norm"].apply_id(t["norm"], torch.cat([a_, b_], dim=-1))
        acc = subs["attn"].apply_id(t["attn"], h, cache, pos)
        return subs["add"].apply_id(t["add"], s_x, acc)

    def init_cache(self, B: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        """One application's float K/V cache."""
        return self._subs()["attn"].init_cache(B, max_len, dtype, device)
