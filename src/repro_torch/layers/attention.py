"""Grouped-query attention (port of `repro.layers.attention.QAttention`:
the float forward `apply_float` with its cache branch, `init_cache`,
`deploy` and `apply_id` over both of its paths and the blockwise one;
`d_in` for zamba2's shared block, whose wq / wk / wv read the 2 d-wide
concat).

The float forward (FullPrecision, calibration's pass, FakeQuantized
training) runs causal attention over the whole sequence in float32:
q/k/v matmuls, float RoPE, scores, softmax and P.V as plain torch
operations, observing q, k, v (before RoPE), each kv head's K and V
(after RoPE, what the cache stores: the int4 pools' per-head ranges),
the probabilities and ctx.  No library attention call stands in: the
calibrator reads the probabilities.  With a float cache (bfloat16 K/V,
contiguous or paged) it writes the new rows in place and attends over
every cached position under the length mask (`apply_float`,
`_cache_write`).

ID dataflow per layer (B slot rows, S query rows each):

    s_x --wq/wk/wv GEMM + q/k/v_rqt epilogue--> int8 q, k, v   (zp=0)
        --integer RoPE (q, k)-->
        --paged column write of k, v through the page table-->
        --paged attention kernel--> int32 P.V accumulator
        --ctx_rqt (requant kernel)--> int8 ctx --wo GEMM--> int32

The path is picked as the reference's `apply_id` picks it, from
`launch.variants`: the paged attention kernel under
``paged_decode="kernel"`` and the float island (``attn_softmax``
"float"), the defaults; otherwise write-then-gather
(`_paged_cache_update`): the same column write, then the dense logical
(B, K, T, hd) view gathered through the table (T = pps * ps; at kv_bits
4 unpacked per kv head by `kv4_unpack`, the reference's
`apply_rqt(unpack_int4(view), k_unpack, channel_axis=1)`), and the
dense branch (`_dense_attend`):

    int32 scores q K^T       (grouped int8 GEMM, one group a slot and
                              kv head: q's group * S rows against the
                              kv head's T keys, no repeat of K)
    == island ==             "int": `core.intsoftmax.int_softmax` under
                             the causal bool mask -> int8 image, no
                             float operation;  "float": the kernel's
                             island (`island_probs`: score_scale, -1e9
                             mask, `island_exp`, its row-sum order),
                             round(127 p) -> int8 image
    int32 P.V                (grouped int8 GEMM over the image, T
                              padded with zero columns to a multiple of
                              16, against V stored (hd, T) a group)

then ctx_rqt and wo as on the kernel path.  Under the float island the
gather path gives the kernel path's image, so both give one result on
each device, as the reference states for its two paths.  torch has no
int8 product on CUDA that takes these batched shapes (`torch._int_mm`
is 2-D and needs more than 16 rows), and a float32 product would put
float operations into the integer path, so both products run on the
port's grouped GEMM kernel (`int8_matmul_grouped`, int32 out).

Query row s of slot b sits at position pos[b] + s.  Rows parked at
INACTIVE_POS write only to the PAGE_NULL trash page and compute
garbage the engine never reads, exactly as in the reference.

The KV pools are updated IN PLACE (`_paged_column_write`), which JAX
cannot do: the reference returns new pools from every step, the port
mutates the arena's tensors.

Int4-packed pools (kv_bits 4): a pool whose trailing axis is hd/2
holds two int4 nibbles per int8 cell.  The write requantizes each new
int8 K/V column into [-8, 7] per kv head (`_kv4_pack_image`, rounding
to nearest) and packs it (`pack_int4`); the kernel unpacks every page
load back into the int8 image space with the per-head unpack tables,
handed to it as (6, K) int32 operands (`_kv4_operand`), and the gather
path unpacks its view with the same operands.  `deploy` emits those
tables as `kv4` (`_kv4_tables`); `kv4_load` adds the operands and the
pack side's rounding term once, when the tables are loaded, so a step
builds neither.  `deploy` also emits the integer softmax's `sm_tabs`
(`core.intsoftmax.make_int_softmax_tables` at the score quantum).

Above BLOCKWISE_THRESHOLD (4096) query rows the reference's dense
branch streams instead (`_blockwise_id`), and the port takes that path
where the reference does: over a contiguous cache (`DecoderLM.
init_caches`, marked ``"contiguous"``: the slot arena and the
whole-prompt scratch), whatever the variants say, and on the gather
path over pools.  Over a paged arena on the kernel path the kernel
stays, as the reference's has no width limit.  `_blockwise_attend`
scans the keys in blocks of 2048 with a running max, sum and float32
accumulator, each block's products on the grouped GEMM and its island
as the reference's XLA lowering computes it (its exp, the fused
multiply-adds of its update, / 127 as a product with the reciprocal),
and ends in round(127 ctx) as int32 for ctx_rqt.

Kv-head sharding.  Under a serving profile whose mesh splits the kv
heads (`sharding.hints.use_profile`, entered by the engine of a
kv-sharded arena; `sharding.rules.kv_head_range`), every branch
computes this rank's contiguous kv heads and their H / n query heads
alone: the K/V column write touches the rank's pools, the paged
kernel (given the rank's own q, pools and unpack columns: the wrapper
knows no mesh), the gather path's grouped products (one group a slot
and local kv head), the integer softmax and the blockwise branch run
over them, and ctx_rqt writes their int8 rows.  The engine cuts each
layer's `kv4` tables to the rank's heads once (`kv4_shard`, through
`models.lm.shard_tables`).
Those rows are all-gathered over the mesh's "model" group, rank-major,
which is head order, and wo runs on every rank over the whole row.
Integer stages make the result the unsharded one bit for bit.  The
reference's GSPMD sharding hints have no counterpart
(`sharding.hints.hint`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.intmath import pack_int4
from repro_torch.core.island import exp_f32, exp_image, fma
from repro_torch.core.intsoftmax import int_softmax, make_int_softmax_tables
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.int8_matmul import int8_matmul_grouped
from repro_torch.kernels.paged_attention import (
    gathered_view, island_probs, kv4_unpack, paged_attention,
)
from repro_torch.kernels.requant_kernel import requant
from repro_torch.launch import variants
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import ActKind, DeployCtx, float_matmul
from repro_torch.layers.linear import QLinear
from repro_torch.layers.rope import (
    apply_rope_fp, gather_trig, rope_tables_fp, rope_tables_int, rotate_int,
)
from repro_torch.sharding.hints import profile_mesh
from repro_torch.sharding.rules import kv_head_range

EPS_P = 1.0 / 127.0  # probability quantum (symmetric int8, zp=0)
NEG_INF = -1e9  # the float forward's causal mask
PAGE_NULL = 0  # physical page 0 is the trash page
INACTIVE_POS = 1 << 30  # parked rows: past every cache, int32-safe
# above this many query rows the dense branch streams over key blocks of
# half its size (the reference's `QAttention.BLOCKWISE_THRESHOLD`)
BLOCKWISE_THRESHOLD = 4096
BLOCKWISE_BLOCK = BLOCKWISE_THRESHOLD // 2
# query rows of one blockwise tile: at most this many (row, key) scores
# of all heads at once, which bounds the island's temporaries (smaller
# on the host, where a tile that stays in cache runs faster; the
# result does not depend on the tiling)
BLOCKWISE_TILE_SCORES = {"cpu": 1 << 20, "cuda": 1 << 26}
# the reference divides the block's P.V and image sum by 127, which its
# XLA lowering computes as a product with the float32 reciprocal
_INV127 = float(np.float32(1.0 / 127.0))


@functools.lru_cache(maxsize=8)
def _rope_cached(hd: int, max_seq: int, base: float, fraction: float,
                 device: str):
    return rope_tables_int(hd, max_seq, base, fraction, device=device)


@functools.lru_cache(maxsize=8)
def _rope_fp_cached(hd: int, max_seq: int, base: float, fraction: float,
                    device: str):
    return rope_tables_fp(hd, max_seq, base, fraction, device=device)


def _causal_mask(S: int, device) -> torch.Tensor:
    """(S, S) float32: 0 where key j <= query i, NEG_INF elsewhere."""
    i = torch.arange(S, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(
        torch.float32)


@dataclasses.dataclass(frozen=True)
class QAttention:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    max_seq: int = 4096
    name: str = "attn"
    d_in: int = 0  # input width where not d_model (zamba2's concat)

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def _sub(self):
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        d_in = self.d_in or self.d_model
        return {
            "wq": QLinear(d_in, H * hd),
            "wk": QLinear(d_in, K * hd),
            "wv": QLinear(d_in, K * hd),
            "wo": QLinear(H * hd, self.d_model),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        return {n: lay.init_np(rng) for n, lay in self._sub().items()}

    def apply_float(self, p: dict, x: torch.Tensor, calib=None,
                    scope: str = "", *, rep: Rep = Rep.FP,
                    cache: Optional[dict] = None, pos=None) -> torch.Tensor:
        """FullPrecision (or, with ``rep=Rep.FQ``, FakeQuantized)
        forward, x (B, S, d) float -> the wo output (B, S, d) in x's
        dtype.  The scores are float32 whatever x's dtype (the
        reference's einsum asks for a float32 result: bfloat16 products
        are exact in float32), the softmax is float32 and the
        probabilities go back to x's dtype for the P.V product
        (`float_matmul`).

        Without a cache the S rows sit at positions 0..S-1 under the
        causal mask.  With one (the reference's float cache branch) the
        rows sit at `pos` (None or an int: shared; a (B,) tensor: per
        row) and their K / V are written into it IN PLACE, cast to its
        dtype (bfloat16 from `init_cache`): a contiguous {"k", "v"} (B,
        K, T, hd) (`_cache_write`), or pools {"k", "v": (n_pages + 1, K,
        ps, hd), "table": (B, pps)} through the table at a (B,) `pos`
        (`_paged_write`, then the view through the table, T = pps *
        ps); then the rows
        attend over the T cached positions, cast back to x's dtype,
        under the length mask (key j visible where j <= the row's
        position)."""
        subs = self._sub()
        B, S, _ = x.shape
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q = subs["wq"].apply(p["wq"], x, rep)
        k = subs["wk"].apply(p["wk"], x, rep)
        v = subs["wv"].apply(p["wv"], x, rep)
        if calib is not None:
            calib.observe(f"{scope}{self.name}.q", q)
            calib.observe(f"{scope}{self.name}.k", k)
            calib.observe(f"{scope}{self.name}.v", v)
        q = q.reshape(B, S, H, hd).permute(0, 2, 1, 3)
        k = k.reshape(B, S, K, hd).permute(0, 2, 1, 3)
        v = v.reshape(B, S, K, hd).permute(0, 2, 1, 3)
        rot, cos, sin = _rope_fp_cached(hd, self.max_seq, self.rope_base,
                                        self.rope_fraction, str(x.device))
        positions = _positions(S, pos, x.device)
        q = apply_rope_fp(q, cos, sin, positions, rot)
        k = apply_rope_fp(k, cos, sin, positions, rot)
        if calib is not None:
            for h in range(K):
                calib.observe(f"{scope}{self.name}.k.h{h}", k[:, h])
                calib.observe(f"{scope}{self.name}.v.h{h}", v[:, h])
        if cache is None:
            mask = _causal_mask(S, x.device)
        else:
            if "table" in cache:
                _paged_write(cache, k, v, pos)
                k_all = gathered_view(cache["k"], cache["table"], 1)
                v_all = gathered_view(cache["v"], cache["table"], 1)
            else:
                _cache_write(cache["k"], k, pos)
                _cache_write(cache["v"], v, pos)
                k_all, v_all = cache["k"], cache["v"]
            k, v = k_all.to(x.dtype), v_all.to(x.dtype)
            mask = torch.where(_float_keep(S, k.shape[2], positions),
                               0.0, NEG_INF).to(torch.float32)
        kh = k.repeat_interleave(self.group, dim=1)
        vh = v.repeat_interleave(self.group, dim=1)
        f32 = torch.float32
        scores = torch.matmul(q.to(f32), kh.to(f32).transpose(-1, -2))
        scores = scores / float(np.sqrt(hd))
        scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        if calib is not None:
            calib.observe(f"{scope}{self.name}.probs", probs)
        ctx_ = float_matmul(probs.to(x.dtype), vh)
        ctx_ = ctx_.permute(0, 2, 1, 3).reshape(B, S, H * hd)
        if calib is not None:
            calib.observe(f"{scope}{self.name}.ctx", ctx_)
        return subs["wo"].apply(p["wo"], ctx_, rep)

    def init_cache(self, B: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        """The float forward's zeroed contiguous cache {"k", "v": (B, K,
        max_len, hd)} in `dtype` (the reference's `init_cache` at FP /
        FQ; the ID cache is the model's int8 pools)."""
        shape = (B, self.n_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _qkv_acts(self):
        rt2 = float(np.sqrt(2.0))  # RoPE rotation headroom
        return {
            "q": QAct(ActKind.IDENTITY, sym=True, range_scale=rt2,
                      name=f"{self.name}.q"),
            "k": QAct(ActKind.IDENTITY, sym=True, range_scale=rt2,
                      name=f"{self.name}.k"),
            "v": QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.v"),
            "ctx": QAct(ActKind.IDENTITY, sym=True, name=f"{self.name}.ctx"),
        }

    def deploy(
        self, ctx: DeployCtx, scope: str, p_np: dict, eps_x: float, zp_x: int
    ) -> Tuple[dict, np.ndarray]:
        """-> (tables, eps_acc_out per channel of the wo accumulator)."""
        subs = self._sub()
        acts = self._qkv_acts()
        t: dict = {}
        eps = {}
        for nm in ("wq", "wk", "wv"):
            ip, eps_acc = subs[nm].deploy(p_np[nm], eps_x, zp_x)
            t[nm] = ip
            short = nm[1]
            a_t, a_eps, a_zp = acts[short].deploy(
                ctx, scope, eps_acc, 0, subs[nm].acc_bound())
            assert a_zp == 0
            t[f"{short}_rqt"] = a_t["rqt"]
            eps[short] = a_eps
        eps_s = eps["q"] * eps["k"] / np.sqrt(self.head_dim)
        t["score_scale"] = np.float32(eps_s)
        t["sm_tabs"] = make_int_softmax_tables(float(eps_s))
        ctx_t, ctx_eps, ctx_zp = acts["ctx"].deploy(
            ctx, scope, EPS_P * eps["v"], 0, acc_bound=260.0 * 127.0)
        assert ctx_zp == 0
        t["ctx_rqt"] = ctx_t["rqt"]
        t["kv4"] = self._kv4_tables(ctx, scope, eps)
        ip, eps_acc_o = subs["wo"].deploy(p_np["wo"], ctx_eps, 0)
        t["wo"] = ip
        return t, eps_acc_o

    def _kv4_tables(self, ctx: DeployCtx, scope: str, eps: dict) -> dict:
        """Per-kv-head int4 requant tables of the packed KV arena.

        Each head's int4 quantum eps4 is in int8-IMAGE units: the head's
        calibrated abs-max (names ``{scope}{name}.{k,v}.h{h}``, post
        RoPE) over the int8 quantum, divided by 7 and floored at 1; a
        head missing from calibration takes the full image (abs-max
        127).  ``*_pack`` maps the int8 image into [-8, 7] (ratio
        1/eps4), ``*_unpack`` maps stored int4 back into the same int8
        image space (ratio eps4)."""
        out = {}
        for short in ("k", "v"):
            eps8 = float(eps[short])
            amax_img = np.empty(self.n_kv_heads, np.float64)
            for h in range(self.n_kv_heads):
                nm = f"{scope}{self.name}.{short}.h{h}"
                if ctx.calib is not None and nm in getattr(
                        ctx.calib, "hi", {}):
                    lo, hi = ctx.calib.range(nm)
                    amax_img[h] = max(abs(float(lo)), abs(float(hi))) / eps8
                else:
                    amax_img[h] = 127.0
            eps4 = np.maximum(amax_img / 7.0, 1.0)
            out[f"{short}_pack"] = make_rqt(
                1.0 / eps4, 1.0, qmin=-8, qmax=7, acc_bound=127.0)
            out[f"{short}_unpack"] = make_rqt(eps4, 1.0, acc_bound=8.0)
        return out

    def apply_id(self, t: dict, s_x: torch.Tensor, cache: dict,
                 pos: torch.Tensor) -> torch.Tensor:
        """s_x (B, S, d) int8 (zp=0); cache {"k", "v": (n_pages + 1, K,
        ps, hd) int8 pools of this layer — (.., hd/2) when int4-packed,
        K / n kv heads on a kv-sharded rank — "table": (B, pps)
        int32}; pos (B,) int32 position of each row's first query.
        Writes the new K/V columns into the pools in place and returns
        the int32 wo accumulator (B, S, d)."""
        subs = self._sub()
        B, S, _ = s_x.shape
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q = subs["wq"].apply_id(t["wq"], s_x, t["q_rqt"])
        k = subs["wk"].apply_id(t["wk"], s_x, t["k_rqt"])
        v = subs["wv"].apply_id(t["wv"], s_x, t["v_rqt"])
        q = q.reshape(B, S, H, hd).permute(0, 2, 1, 3)
        k = k.reshape(B, S, K, hd).permute(0, 2, 1, 3)
        v = v.reshape(B, S, K, hd).permute(0, 2, 1, 3)
        rot, cos_q, sin_q = _rope_cached(
            hd, self.max_seq, self.rope_base, self.rope_fraction,
            str(s_x.device))
        positions = pos.to(torch.int64)[:, None] + torch.arange(
            S, device=s_x.device)
        c, s = gather_trig(cos_q, sin_q, positions)
        mesh = profile_mesh()
        kr = kv_head_range(K, mesh)
        kv4 = t["kv4"] if cache["k"].shape[-1] != hd else None
        if kr is not None:  # this rank's kv heads and their query heads
            k, v = k[:, kr], v[:, kr]
            q = q[:, kr.start * self.group:kr.stop * self.group]
            if kv4 is not None and kv4["k_rq"].shape[1] != kr.stop - kr.start:
                raise ValueError("a kv-sharded rank's kv4 tables must hold "
                                 "its kv heads (models.lm.shard_tables)")
        q = rotate_int(q, c, s, rot).contiguous()
        k = rotate_int(k, c, s, rot)
        kernel = (variants.get("paged_decode") == "kernel"
                  and variants.get("attn_softmax") != "int")
        if S > BLOCKWISE_THRESHOLD and (cache.get("contiguous")
                                        or not kernel):
            k_view, v_view = _paged_cache_update(cache, k, v, pos, kv4=kv4)
            acc = _blockwise_attend(q, k_view, v_view, pos,
                                    t["score_scale"], self.group)
        elif kernel:
            _paged_write(cache, k, v, pos, kv4=kv4)
            kw = ({} if kv4 is None
                  else dict(k_rq=kv4["k_rq"], v_rq=kv4["v_rq"]))
            acc = paged_attention(q, cache["k"], cache["v"], cache["table"],
                                  pos, t["score_scale"], group=self.group,
                                  **kw)
        else:
            k_view, v_view = _paged_cache_update(cache, k, v, pos, kv4=kv4)
            acc = self._dense_attend(t, q, k_view, v_view, pos)
        s_ctx = requant(acc, t["ctx_rqt"], heads_to_rows=True)
        if kr is not None:  # the ranks' rows in head order
            parts = [torch.empty_like(s_ctx)
                     for _ in range(K // (kr.stop - kr.start))]
            dist.all_gather(parts, s_ctx, group=mesh.get_group("model"))
            s_ctx = torch.cat(parts, dim=2)
        s_ctx = s_ctx.view(B, S, H * hd)
        return subs["wo"].apply_id(t["wo"], s_ctx)

    def _dense_attend(self, t: dict, q: torch.Tensor, k_view: torch.Tensor,
                      v_view: torch.Tensor, pos: torch.Tensor
                      ) -> torch.Tensor:
        """The reference's dense branch over the gathered views: q (B,
        H, S, hd) int8 contiguous, k_view / v_view (B, K, T, hd) int8
        contiguous (H = K group: all heads, or a kv-sharded rank's) ->
        the int32 P.V accumulator (B, H, S, hd).  Both
        products are one grouped GEMM launch each, group b * K + kv
        head; the island is the integer softmax under ``attn_softmax
        "int"``, else the float island of the kernel."""
        B, H, S, hd = q.shape
        K, G = k_view.shape[1], self.group
        T = k_view.shape[2]
        scores = int8_matmul_grouped(
            q.view(1, B * K, G * S, hd),
            k_view.view(B * K, T, hd).transpose(1, 2)).view(B, H, S, T)
        if variants.get("attn_softmax") == "int" and "sm_tabs" in t:
            s_p = int_softmax(scores, t["sm_tabs"],
                              mask=_bool_mask(S, T, pos))
        else:
            s_p = torch.round(island_probs(scores, pos, t["score_scale"])
                              * 127.0).to(torch.int8)
        pad = (-T) % 16
        vt = v_view.transpose(2, 3)                      # (B, K, hd, T)
        if pad:
            s_p = torch.nn.functional.pad(s_p, (0, pad))
            vt = torch.nn.functional.pad(vt, (0, pad))
        else:
            vt = vt.contiguous()
        acc = int8_matmul_grouped(
            s_p.view(1, B * K, G * S, T + pad),
            vt.view(B * K, hd, T + pad).transpose(1, 2))
        return acc.view(B, H, S, hd)


def _blockwise_attend(q: torch.Tensor, k_view: torch.Tensor,
                      v_view: torch.Tensor, pos: torch.Tensor,
                      score_scale: torch.Tensor, group: int
                      ) -> torch.Tensor:
    """The reference's `_blockwise_id` up to its ctx_rqt: q (B, H, S,
    hd) int8, k_view / v_view (B, K, T, hd) int8, T a multiple of
    BLOCKWISE_BLOCK -> round(127 ctx) (B, H, S, hd) int32.

    For each block of keys: int32 scores on the grouped GEMM, logits
    scores * score_scale masked to NEG_INF past each row's position,
    the running max m, p = exp(logits - m) and its image round(127 p)
    as int8 (`core.island.exp_image`), P.V on the grouped GEMM, corr =
    exp(m_old - m), acc = acc corr + pv / 127 and l = l corr +
    sum(image) / 127, each update one fused multiply-add and each / 127
    a product with the float32 reciprocal, as the reference's lowering
    computes them; at the end ctx = acc / max(l, 1e-9).  Query rows run
    in tiles (their results do not depend on one another), and a tile
    skips the blocks wholly past its last row's position: there p is
    0, corr 1 and the update leaves acc and l as they were."""
    B, H, S, hd = q.shape
    K = H // group
    T = k_view.shape[2]
    blk = BLOCKWISE_BLOCK
    if T % blk:
        raise ValueError(f"blockwise attention needs T % {blk} == 0, got "
                         f"(T, block) = {(T, blk)}")
    dev = q.device
    scale = score_scale.to(torch.float32)
    k_blocks = [k_view[:, :, j:j + blk].reshape(B * K, blk, hd).contiguous()
                for j in range(0, T, blk)]
    v_blocks = [v_view[:, :, j:j + blk].transpose(2, 3).reshape(
        B * K, hd, blk).contiguous() for j in range(0, T, blk)]
    rows = max(1, min(S, BLOCKWISE_TILE_SCORES[dev.type] // (B * H * blk)))
    p0 = pos.to(torch.int64)
    first_max = int(p0.max())  # one read of the positions a layer
    out = torch.empty((B, H, S, hd), dtype=torch.int32, device=dev)
    for r0 in range(0, S, rows):
        R = min(rows, S - r0)
        q_t = q[:, :, r0:r0 + R].reshape(1, B * K, group * R,
                                         hd).contiguous()
        q_pos = p0[:, None] + torch.arange(r0, r0 + R, device=dev)  # (B,R)
        m = torch.full((B, H, R), NEG_INF, dtype=torch.float32, device=dev)
        l_ = torch.zeros((B, H, R), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, R, hd), dtype=torch.float32, device=dev)
        n_blk = min(T // blk, (first_max + r0 + R - 1) // blk + 1)
        for j in range(n_blk):
            s = int8_matmul_grouped(q_t, k_blocks[j].transpose(1, 2))
            logits = s.view(B, H, R, blk).to(torch.float32) * scale
            k_pos = torch.arange(j * blk, (j + 1) * blk, device=dev)
            keep = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
            logits = torch.where(keep, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            qp = exp_image(logits - m_new[..., None])
            pv = int8_matmul_grouped(
                qp.view(1, B * K, group * R, blk),
                v_blocks[j].transpose(1, 2)).view(B, H, R, hd)
            corr = exp_f32(m - m_new)
            acc = fma(acc, corr[..., None], pv.to(torch.float32) * _INV127)
            l_ = fma(l_, corr, qp.to(torch.float32).sum(-1) * _INV127)
            m = m_new
        ctx = acc / torch.clamp_min(l_, 1e-9)[..., None]
        out[:, :, r0:r0 + R] = torch.round(ctx * 127.0).to(torch.int32)
    return out


def _bool_mask(S: int, T: int, pos: torch.Tensor) -> torch.Tensor:
    """Causal keep-mask (B, 1, S, T): key j is visible to query row s
    of slot b where j <= pos[b] + s."""
    i = pos.to(torch.int64)[:, None] + torch.arange(S, device=pos.device)
    j = torch.arange(T, device=pos.device)
    return (j[None, None, :] <= i[:, :, None])[:, None]


def _positions(S: int, pos, device) -> torch.Tensor:
    """The float forward's query positions: (S,) from 0 (pos None) or
    from an int, (B, S) from a (B,) tensor (a 0-d tensor is an int)."""
    r = torch.arange(S, device=device)
    if pos is None:
        return r
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 1:
            return pos.to(device=device, dtype=torch.int64)[:, None] + r
        pos = int(pos)
    return pos + r


def _float_keep(S: int, T: int, positions: torch.Tensor) -> torch.Tensor:
    """The length keep-mask of the float cache branch: key j visible to
    a row at position i where j <= i; (S, T) for shared positions, (B,
    1, S, T) for per-row ones."""
    j = torch.arange(T, device=positions.device)
    if positions.dim() == 2:
        return (j[None, None, :] <= positions[:, :, None])[:, None]
    return j[None, :] <= positions[:, None]


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write `new` (B, K, S, hd) into the contiguous float cache (B, K,
    T, hd) IN PLACE, cast to its dtype (the reference's `_cache_write`).

    A per-row `pos` (B,) writes row b at [pos[b], pos[b] + S),
    positions past T dropped (rows parked at INACTIVE_POS write
    nothing).  A shared `pos` writes [pos, pos + S) with the start
    clamped to [0, T - S], as `dynamic_update_slice` clamps it (S == T
    replaces the whole cache).  The reference's single-token write is
    the one-hot rewrite cache * (1 - oh) + new * oh: every kept cell is
    cache * 1 + new * 0, the written one cache * 0 + new * 1, both exact
    in floating point, so plain indexing gives its values (only a
    written -0.0 over a cell of +0.0 keeps its sign here, where the
    rewrite's sum gives +0.0; the two compare equal)."""
    B, _, S, _ = new.shape
    T = cache.shape[2]
    new = new.to(cache.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        t = pos.to(device=cache.device, dtype=torch.int64)[:, None] + \
            torch.arange(S, device=cache.device)           # (B, S)
        ok = t < T
        b = torch.arange(B, device=cache.device)[:, None].expand(B, S)
        cache[b[ok], :, t[ok], :] = new.permute(0, 2, 1, 3)[ok]
        return
    start = 0 if pos is None else int(pos)
    start = min(max(start, 0), T - S)
    cache[:, :, start:start + S, :] = new


def _write_plan(pos: torch.Tensor, table: torch.Tensor, S: int,
                n_pool: int, ps: int):
    """Where a chunk (B, ., S, .) lands: -> (page, off, src), each
    (B*S,).  Row b writes positions [pos[b], pos[b] + S): token s goes
    to page table[b, (pos[b] + s) // ps] at offset (pos[b] + s) % ps.
    Positions past the table's logical length (parked rows, the padded
    tail of a partial chunk) and PAGE_NULL entries land on the trash
    page.  Where several writes hit one cell (only ever on the trash
    page), `src` makes every one of them write the LAST writer's row,
    so the result is the reference scatter's last-write-wins on any
    device and in any write order."""
    pps = table.shape[1]
    positions = pos.to(torch.int64)[:, None] + torch.arange(
        S, device=table.device)
    valid = positions < pps * ps
    blk = torch.clamp(torch.div(positions, ps, rounding_mode="floor"),
                      0, pps - 1)
    page = torch.gather(table.to(torch.int64), 1, blk)
    page = torch.where(valid, page, torch.full_like(page, PAGE_NULL))
    off = torch.remainder(positions, ps)
    page, off = page.reshape(-1), off.reshape(-1)
    cell = page * ps + off
    last = torch.full((n_pool * ps,), -1, dtype=torch.int64,
                      device=table.device)
    last.scatter_reduce_(0, cell, torch.arange(
        cell.numel(), device=table.device), reduce="amax")
    return page, off, last[cell]


def _paged_column_write(pool: torch.Tensor, new: torch.Tensor,
                        plan) -> None:
    """Scatter a chunk (B, K, S, hd) into the pool, in place, along a
    `_write_plan`."""
    page, off, src = plan
    B, K, S, hd = new.shape
    rows = new.permute(0, 2, 1, 3).reshape(B * S, K, hd)
    pool[page, :, off, :] = rows[src].to(pool.dtype)


def _kv4_operand(rqt: dict, n_kv_heads: int) -> torch.Tensor:
    """A kv4 requant tree as one (6, K) int32 kernel operand: rows m,
    s0, lo, hi, d, zp, each per kv head (scalar entries repeat across
    K)."""
    rows = (rqt["m"], rqt["s0"], rqt["lo"], rqt["hi"], rqt["d"], rqt["zp"])
    return torch.stack([r.to(torch.int32).reshape(-1).expand(n_kv_heads)
                        for r in rows])


def kv4_shard(kv4: dict, kr: slice) -> dict:
    """A layer's loaded `kv4` tables (`kv4_load`) for a kv-sharded rank
    whose pools hold the kv heads `kr`: the per-head entries of the
    pack and unpack tables and the (6, K) operands cut to those heads,
    scalar entries kept."""
    K = kv4["k_rq"].shape[1]
    out = dict(kv4)
    for short in ("k", "v"):
        for kind in ("pack", "unpack"):
            out[f"{short}_{kind}"] = {
                n: x[kr] if x.dim() == 1 and x.shape[0] == K else x
                for n, x in kv4[f"{short}_{kind}"].items()}
        out[f"{short}_rq"] = kv4[f"{short}_rq"][:, kr].contiguous()
    return out


def kv4_load(kv4: dict) -> dict:
    """One layer's deployed `kv4` tables (torch int32) -> the same tree
    plus what the serving path reads, built once when the tables are
    loaded (`models.lm.load_layer`): the unpack tables as the kernel's
    (6, K) operands ``k_rq``/``v_rq`` (K from the per-head m), and in
    each pack table its rounding term ``half``, 2^(d-1), 0 for d 0."""
    out = dict(kv4)
    for short in ("k", "v"):
        unpack = kv4[f"{short}_unpack"]
        out[f"{short}_rq"] = _kv4_operand(unpack, unpack["m"].numel())
        pack = kv4[f"{short}_pack"]
        d = int(pack["d"])
        out[f"{short}_pack"] = dict(pack, half=torch.tensor(
            1 << (d - 1) if d > 0 else 0, dtype=torch.int32,
            device=pack["d"].device))
    return out


def _kv4_pack_image(x: torch.Tensor, rqt: dict) -> torch.Tensor:
    """int8 KV image (B, K, S, hd) -> int4 image in [-8, 7], per-kv-head
    quanta along axis 1, ROUNDING TO NEAREST: (q * m + half) >> d with
    half = 2^(d-1) for d > 0 (s0 is 0 by construction), not
    `apply_rqt`'s floor shift.  ``rqt`` is a pack table as `kv4_load`
    leaves it, ``half`` included.  Only the unpack side, which the
    kernel replays, is the floor-shift formula."""
    m, d, half = rqt["m"], rqt["d"], rqt["half"]
    lo, hi = rqt["lo"], rqt["hi"]
    if m.dim() == 1 and m.shape[0] > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1] = -1
        m, lo, hi = m.reshape(shape), lo.reshape(shape), hi.reshape(shape)
    q = torch.minimum(torch.maximum(x.to(torch.int32), lo), hi)
    out = torch.bitwise_right_shift(q * m + half, d)
    return out.clamp(-8, 7).to(torch.int8)


def _paged_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, kv4: Optional[dict] = None) -> None:
    """Write the new K/V column(s) of every row through the page table
    (in place on the cache's pools; K and V share one write plan).
    With `kv4` (int4-packed pools, the tables as `kv4_load` leaves
    them) each int8 column is first
    requantized per kv head into [-8, 7] and nibble-packed along hd;
    both nibbles of a cell belong to one position, so the write plan
    is the int8 one."""
    if pos.dim() != 1:
        raise ValueError("paged KV caches need a per-slot position vector")
    if kv4 is not None:
        k = pack_int4(_kv4_pack_image(k, kv4["k_pack"]))
        v = pack_int4(_kv4_pack_image(v, kv4["v_pack"]))
    n_pool, _, ps, _ = cache["k"].shape
    plan = _write_plan(pos, cache["table"], k.shape[2], n_pool, ps)
    _paged_column_write(cache["k"], k, plan)
    _paged_column_write(cache["v"], v, plan)


def _paged_cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, kv4: Optional[dict] = None):
    """Write-then-gather: the new column(s) written through the page
    table as on the kernel path (`_paged_write`, in place), then the
    dense views through the table, which include them (T = pps * ps;
    PAGE_NULL entries surface the trash page, which the causal mask
    hides).  With `kv4` the packed views are unpacked per kv head
    through the kernel's unpack operands (`kv4_unpack`).  -> (k_view,
    v_view), (B, K, T, hd) int8."""
    _paged_write(cache, k, v, pos, kv4=kv4)
    k_view = gathered_view(cache["k"], cache["table"], 1)
    v_view = gathered_view(cache["v"], cache["table"], 1)
    if kv4 is not None:
        k_view = kv4_unpack(k_view, kv4["k_rq"])
        v_view = kv4_unpack(v_view, kv4["v_rq"])
    return k_view, v_view
