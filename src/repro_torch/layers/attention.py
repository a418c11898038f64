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

Left out of this slice: the contiguous cache, the blockwise path for
S > 4096, the integer-softmax variant, int4-packed pools, sharding
hints and the `launch.variants` switches; `deploy` omits the
reference's `sm_tabs` and `kv4` tables, which only those paths read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

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
        ip, eps_acc_o = subs["wo"].deploy(p_np["wo"], ctx_eps, 0)
        t["wo"] = ip
        return t, eps_acc_o

    def apply_id(self, t: dict, s_x: torch.Tensor, cache: dict,
                 pos: torch.Tensor) -> torch.Tensor:
        """s_x (B, S, d) int8 (zp=0); cache {"k", "v": (n_pages + 1, K,
        ps, hd) int8 pools of this layer, "table": (B, pps) int32};
        pos (B,) int32 position of each row's first query.  Writes the
        new K/V columns into the pools in place and returns the int32
        wo accumulator (B, S, d)."""
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
        _paged_write(cache, k, v, pos)
        acc = paged_attention(q, cache["k"], cache["v"], cache["table"], pos,
                              t["score_scale"], group=self.group)
        s_ctx = requant(acc, t["ctx_rqt"])
        s_ctx = s_ctx.permute(0, 2, 1, 3).reshape(B, S, H * hd)
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


def _paged_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write the new K/V column(s) of every row through the page table
    (in place on the cache's pools; K and V share one write plan)."""
    if pos.dim() != 1:
        raise ValueError("paged KV caches need a per-slot position vector")
    n_pool, _, ps, _ = cache["k"].shape
    plan = _write_plan(pos, cache["table"], k.shape[2], n_pool, ps)
    _paged_column_write(cache["k"], k, plan)
    _paged_column_write(cache["v"], v, plan)
