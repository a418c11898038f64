"""Grouped-query attention, paged integer serving path (port of
`repro.layers.attention.QAttention`: `deploy` and the paged-kernel
branch of `apply_id`).

ID dataflow per layer (B slot rows, S query rows each):

    s_x --wq/wk/wv GEMM + q/k/v_rqt epilogue--> int8 q, k, v   (zp=0)
        --integer RoPE (q, k)-->
        --paged column write of k, v through the page table-->
        --paged attention kernel--> int32 P.V accumulator
        --ctx_rqt (requant kernel)--> int8 ctx --wo GEMM--> int32

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
handed to it as (6, K) int32 operands (`_kv4_operand`).  `deploy`
emits those tables as `kv4` (`_kv4_tables`); `kv4_load` adds the
operands and the pack side's rounding term once, when the tables are
loaded, so a step builds neither.

Left out of this slice: the contiguous cache, the blockwise path for
S > 4096, the integer-softmax variant, sharding hints and the
`launch.variants` switches; `deploy` omits the reference's `sm_tabs`,
which only the integer-softmax variant reads.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.intmath import pack_int4
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.requant_kernel import requant
from repro_torch.layers.act_quant import QAct
from repro_torch.layers.common import ActKind, DeployCtx
from repro_torch.layers.linear import QLinear
from repro_torch.layers.rope import gather_trig, rope_tables_int, rotate_int

EPS_P = 1.0 / 127.0  # probability quantum (symmetric int8, zp=0)
PAGE_NULL = 0  # physical page 0 is the trash page
INACTIVE_POS = 1 << 30  # parked rows: past every cache, int32-safe


@functools.lru_cache(maxsize=8)
def _rope_cached(hd: int, max_seq: int, base: float, fraction: float,
                 device: str):
    return rope_tables_int(hd, max_seq, base, fraction, device=device)


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

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def _sub(self):
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        return {
            "wq": QLinear(self.d_model, H * hd),
            "wk": QLinear(self.d_model, K * hd),
            "wv": QLinear(self.d_model, K * hd),
            "wo": QLinear(H * hd, self.d_model),
        }

    def init_np(self, rng: np.random.Generator) -> dict:
        return {n: lay.init_np(rng) for n, lay in self._sub().items()}

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
        ps, hd) int8 pools of this layer — (.., hd/2) when int4-packed
        — "table": (B, pps) int32}; pos (B,) int32 position of each
        row's first query.  Writes the new K/V columns into the pools
        in place and returns the int32 wo accumulator (B, S, d)."""
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
        q = rotate_int(q, c, s, rot).contiguous()
        k = rotate_int(k, c, s, rot)
        kv4 = t["kv4"] if cache["k"].shape[-1] != hd else None
        _paged_write(cache, k, v, pos, kv4=kv4)
        kw = {} if kv4 is None else dict(k_rq=kv4["k_rq"], v_rq=kv4["v_rq"])
        acc = paged_attention(q, cache["k"], cache["v"], cache["table"], pos,
                              t["score_scale"], group=self.group, **kw)
        s_ctx = requant(acc, t["ctx_rqt"], heads_to_rows=True)
        s_ctx = s_ctx.view(B, S, H * hd)
        return subs["wo"].apply_id(t["wo"], s_ctx)


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
