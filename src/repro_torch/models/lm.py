"""The dense decoder LM, integer serving path (port of
`repro.models.lm.DecoderLM`, dense family only).

Lifecycle: numpy init (`init_np`, the reference's shapes and scales)
-> host-side deploy (`deploy`, the reference's integer tables leaf for
leaf, minus the `sm_tabs` tables no ported path reads) -> torch
state (`tables_from_numpy`) -> ID apply (`prefill_chunk`, a Python
loop over the layers where the reference runs `lax.scan`).

Port state layout (what `tables_from_numpy` returns):

    {"meta": {...}, "embed": {...}, "layers": [layer 0 tables, ...],
     "norm_f": {...}, "head": {...}}

i.e. the reference tree with its layer-stacked `segments[0]` split into
a per-layer list (views into the stacked tensors when converted from a
stacked tree).  Every dtype is the reference's; every QLinear weight
`w_q` keeps its (K, N) shape and values but is stored transposed (N,
K) contiguous, the layout the int8 GEMM kernel reads.

KV pools: {"k", "v": (n_layers, n_pages + 1, K, page_size, hd) int8,
"table": (n_slots, pages_per_slot) int32}; the layer loop hands layer
i the views ["k"][i] / ["v"][i] and the shared table.  At kv_bits 4
the pools' trailing axis is hd/2 (two int4 nibbles per cell) and each
layer's `kv4` tables (int32, like every requant table) carry the
per-kv-head pack and unpack images, plus what `load_layer` derives from
them once (the kernel's (6, K) operands and the pack rounding term).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.attention import kv4_load
from repro_torch.layers.common import ActKind, DeployCtx, stack_trees
from repro_torch.layers.embedding import QEmbed
from repro_torch.layers.linear import QLinear
from repro_torch.layers.norms import QNorm
from repro_torch.models.blocks import DenseBlock

ACT_MAP = {"silu": ActKind.SILU, "gelu": ActKind.GELU}
LOGIT_PAD = -(2 ** 30)  # integer mask for padded vocab slots


def _leaf_to_torch(key: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if key == "w_q":
        # (.., K, N) values, stored (.., N, K) contiguous for the kernel
        t = torch.from_numpy(np.swapaxes(a, -1, -2).copy())
        return t.to(device).transpose(-1, -2)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()  # e.g. a read-only view of a JAX array; keeps 0-d
    return torch.from_numpy(a).to(device)


def tree_to_torch(tree: dict, device, key: str = "") -> Any:
    """numpy table tree -> torch tree on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, k) for k, v in tree.items()}
    return _leaf_to_torch(key, tree, device)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


KV_BITS = (8, 4)  # KV storage widths: int8 images or int4-packed pairs


def check_kv_bits(kv_bits: int) -> int:
    """The one check of a KV storage width (`init_pools`, and
    `serving.config.ServingConfig` at construction)."""
    if kv_bits not in KV_BITS:
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    return kv_bits


def load_layer(t: dict) -> dict:
    """One layer's torch tables -> its serving state: the attention's
    `kv4` tables gain what every step would otherwise rebuild
    (`layers.attention.kv4_load`)."""
    return {**t, "attn": {**t["attn"], "kv4": kv4_load(t["attn"]["kv4"])}}


def tables_from_numpy(tables_np: dict, device="cuda") -> dict:
    """A reference-deployed table tree (plain numpy, e.g. after
    `jax.tree.map(np.asarray, tables)`) -> the port's state on
    `device`.  int32 stays int32 (every requant table, the per-head
    `kv4` pack/unpack tables included), int8 stays int8 and the f32
    score_scale stays f32; `segments[0]` becomes the per-layer list,
    each layer through `load_layer`."""
    if len(tables_np["segments"]) != 1:
        raise ValueError("the dense family has exactly one segment")
    stacked = tree_to_torch(tables_np["segments"][0], device)
    n = len(next(iter(_leaves(stacked))))
    return {
        "meta": {k: float(np.asarray(v)) for k, v in
                 tables_np.get("meta", {}).items()},
        "embed": tree_to_torch(tables_np["embed"], device),
        "layers": [load_layer(_index(stacked, i)) for i in range(n)],
        "norm_f": tree_to_torch(tables_np["norm_f"], device),
        "head": tree_to_torch(tables_np["head"], device),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class DecoderLM:
    cfg: ArchConfig
    max_seq: int = 4096

    def __post_init__(self):
        if self.cfg.family != "dense" or self.cfg.input_mode != "tokens":
            raise NotImplementedError(
                "this slice of the port serves the dense token family")

    # -- structure -------------------------------------------------------
    def block(self) -> DenseBlock:
        c = self.cfg
        return DenseBlock(
            d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
            head_dim=c.hd, d_ff=c.d_ff, act=ACT_MAP[c.act], gated=c.gated,
            norm=c.norm, norm_bias=c.norm_bias, rope_base=c.rope_base,
            rope_fraction=c.rope_fraction, max_seq=self.max_seq,
        )

    def embed_layer(self) -> QEmbed:
        return QEmbed(self.cfg.vocab_padded, self.cfg.d_model)

    def norm_f_layer(self) -> QNorm:
        c = self.cfg
        return QNorm(c.d_model, kind=c.norm, use_bias=c.norm_bias)

    def head_layer(self) -> QLinear:
        c = self.cfg
        return QLinear(c.d_model, c.vocab_padded, per_channel=False)

    # -- init (host, numpy) ----------------------------------------------
    # Float params with the reference's shapes and scales.  Each part
    # draws from its own numpy stream keyed by (seed, part), so a
    # layer-by-layer deploy (launch.serve.deploy_model) can draw and
    # deploy layers in any order or in parallel and still equal
    # `deploy(init_np(seed))`.
    def init_embed_np(self, seed: int) -> dict:
        return self.embed_layer().init_np(np.random.default_rng([seed, 0]))

    def init_layer_np(self, seed: int, i: int) -> dict:
        return self.block().init_np(np.random.default_rng([seed, 1, i]))

    def init_head_np(self, seed: int) -> Tuple[dict, dict]:
        """-> (final norm params, head params)."""
        rng = np.random.default_rng([seed, 2])
        return self.norm_f_layer().init_np(), self.head_layer().init_np(rng)

    def init_np(self, seed: int) -> dict:
        """The whole float param tree in the reference's layout
        (layer-stacked segments)."""
        p: Dict[str, Any] = {"embed": self.init_embed_np(seed)}
        p["segments"] = [stack_trees(
            [self.init_layer_np(seed, i) for i in range(self.cfg.n_layers)])]
        p["norm_f"], p["head"] = self.init_head_np(seed)
        return p

    # -- deploy (host, numpy) --------------------------------------------
    def deploy_embed(self, ctx: DeployCtx, p_embed: dict):
        """-> (embed tables, eps of the first residual image)."""
        t, eps_x, _ = self.embed_layer().deploy(ctx, p_embed)
        return t, eps_x

    def deploy_layer(self, ctx: DeployCtx, i: int, p_layer: dict,
                     eps_x: float) -> Tuple[dict, float]:
        return self.block().deploy(ctx, f"S0.L{i}.", p_layer, eps_x)

    def deploy_head(self, ctx: DeployCtx, p_norm: dict, p_head: dict,
                    eps_x: float):
        """-> (norm_f tables, head tables, eps_logits)."""
        tn, eps_h, _ = self.norm_f_layer().deploy(ctx, "final.", p_norm, eps_x)
        th, eps_logits = self.head_layer().deploy(p_head, eps_h, 0)
        return tn, th, float(np.max(eps_logits))

    def deploy(self, p, calib=None, *, factor: int = 256) -> dict:
        """-> integer tables in the reference's layout (numpy)."""
        ctx = DeployCtx(calib=calib, factor=factor)
        t: Dict[str, Any] = {"meta": {}}
        t["embed"], eps_x = self.deploy_embed(ctx, p["embed"])
        t["meta"]["eps_in"] = eps_x
        seg = p["segments"][0]
        layers = []
        for i in range(self.cfg.n_layers):
            ti, eps_x = self.deploy_layer(ctx, i, _index(seg, i), eps_x)
            layers.append(ti)
        t["segments"] = [stack_trees(layers)]
        t["norm_f"], t["head"], t["meta"]["eps_logits"] = self.deploy_head(
            ctx, p["norm_f"], p["head"], eps_x)
        return t

    # -- integer serving path (torch) --------------------------------------
    def init_pools(self, n_pages: int, page_size: int, device="cuda",
                   kv_bits: int = 8) -> dict:
        """Zeroed paged KV pools (page 0 is the PAGE_NULL trash page);
        at kv_bits 4 the trailing head_dim axis is halved (packed)."""
        c = self.cfg
        hd = c.hd
        if check_kv_bits(kv_bits) == 4:
            if hd % 2:
                raise ValueError(f"kv_bits=4 needs an even head_dim, got {hd}")
            hd //= 2
        shape = (c.n_layers, n_pages + 1, c.n_kv_heads, page_size, hd)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
        }

    def embed_in_id(self, t: dict, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_layer().apply_id(t["embed"], tokens)

    def logits_id(self, t: dict, s_x: torch.Tensor) -> torch.Tensor:
        """Final norm + int32 head; padded vocab slots masked."""
        c = self.cfg
        h = self.norm_f_layer().apply_id(t["norm_f"], s_x)
        logits = self.head_layer().apply_id(t["head"], h)
        if c.vocab_padded != c.vocab:
            pad = torch.arange(c.vocab_padded, device=logits.device) >= c.vocab
            logits = logits.masked_fill(pad, LOGIT_PAD)
        return logits

    def prefill_chunk(self, t: dict, batch: torch.Tensor, caches: dict,
                      start_pos: torch.Tensor,
                      last_index: torch.Tensor) -> torch.Tensor:
        """ID batched + chunked prefill over the paged arena.

        batch (B, C) int32 tokens (one chunk per slot row; decode rows
        are width-1 chunks); start_pos (B,) int32 position of each
        row's first token (INACTIVE_POS for parked rows); last_index
        (B,) int32 column whose logits to return.  Writes every row's
        K/V into `caches` in place.  -> (B, 1, vocab_padded) int32."""
        x = self.embed_in_id(t, batch)
        blk = self.block()
        table = caches["table"]
        for i, lt in enumerate(t["layers"]):
            cache_i = {"k": caches["k"][i], "v": caches["v"][i],
                       "table": table}
            x = blk.apply_id(lt, x, cache_i, start_pos)
        rows = torch.arange(x.shape[0], device=x.device)
        h = x[rows, last_index.to(torch.int64)][:, None, :]
        return self.logits_id(t, h)
