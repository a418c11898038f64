"""The decoder LM (port of `repro.models.lm.DecoderLM`, the dense, MoE
and ssm families: `plan()` is one segment of `DenseBlock`s, with a
`QMoE` in every block for MoE at `moe_every` 1, or one segment of
`MambaBlock`s for ssm).

Lifecycle, as the reference's: numpy init (`init_np`, the reference's
shapes and scales) -> calibrate (`calibrate`: the FullPrecision
forward `embed_in` -> `apply` -> `logits` in float32 on the device,
observing every activation range under the reference's names) ->
host-side deploy (`deploy(p, calib)`, the reference's integer tables
leaf for leaf, the integer softmax's `sm_tabs` included;
`deploy(p, None)` is the calibration-free deploy on DEFAULT_RANGES)
-> torch state (`tables_from_numpy`) -> ID apply (`prefill_chunk`, a
Python loop over the layers where the reference runs `lax.scan`).
The float forward is the reference's eager per-layer walk (scopes
`S0.L{i}.`); it has no cache branch.

Port state layout (what `tables_from_numpy` returns):

    {"meta": {...}, "embed": {...}, "layers": [layer 0 tables, ...],
     "norm_f": {...}, "head": {...}}

i.e. the reference tree with its layer-stacked `segments[0]` split into
a per-layer list (views into the stacked tensors when converted from a
stacked tree).  Every dtype is the reference's; every QLinear weight
`w_q` keeps its (K, N) shape and values but is stored transposed (N,
K) contiguous, the layout the int8 GEMM kernel reads, and so are the
MoE's expert weights `wg_q`/`wu_q`/`wd_q`, (E, K, N) stored (E, N, K).

KV pools: {"k", "v": (n_layers, n_pages + 1, K, page_size, hd) int8,
"table": (n_slots, pages_per_slot) int32}; the layer loop hands layer
i the views ["k"][i] / ["v"][i] and the shared table.  The reference's
contiguous cache (B, K, T, hd) is the same layout read as B pages of T
positions, slot b on page b + 1 (`init_caches`): the attention and the
paged kernel serve both.  Page 0, the trash page, takes the writes of
parked rows.  At kv_bits 4
the pools' trailing axis is hd/2 (two int4 nibbles per cell) and each
layer's `kv4` tables (int32, like every requant table) carry the
per-kv-head pack and unpack images, plus what `load_layer` derives from
them once (the kernel's (6, K) operands and the pack rounding term).
Each layer's `sm_tabs` (the integer softmax's m_ln2, d_ln2, ln2_img,
r_step and (256,) exp_lut) stay int32 on the device, the scalars 0-d,
as `core.intsoftmax.int_softmax` reads them: operands of its integer
ops, never read on the host.

The ssm family has no KV pools: its cache is each layer's recurrent
state, {"conv": (n_layers, B, conv_k - 1, d_inner) int8, "h":
(n_layers, B, d_inner, d_state) float32} over B slot rows
(`init_state`, both arenas), which every dispatch advances in place
for every row, parked rows included, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.intsoftmax import int_softmax_load
from repro_torch.layers.attention import kv4_load
from repro_torch.layers.common import ActKind, DeployCtx, stack_trees
from repro_torch.layers.embedding import QEmbed
from repro_torch.layers.linear import QLinear
from repro_torch.layers.moe import EXPERT_WEIGHTS
from repro_torch.layers.norms import QNorm
from repro_torch.layers.ssm import load_core
from repro_torch.models.blocks import DenseBlock, MambaBlock

ACT_MAP = {"silu": ActKind.SILU, "gelu": ActKind.GELU, "relu": ActKind.RELU,
           "relu2": ActKind.RELU2}
LOGIT_PAD = -(2 ** 30)  # integer mask for padded vocab slots
LOGIT_PAD_FP = -1e9  # the float forward's mask for padded vocab slots
# above this many query rows the reference's contiguous-cache attention
# takes its blockwise path (`QAttention.BLOCKWISE_THRESHOLD`), which
# rounds otherwise and is not ported
BLOCKWISE_THRESHOLD = 4096


def check_contiguous_width(S: int) -> int:
    """Query rows of one dispatch over contiguous caches: at most
    BLOCKWISE_THRESHOLD, where the reference changes its rounding."""
    if S > BLOCKWISE_THRESHOLD:
        raise NotImplementedError(
            f"{S} query rows over a contiguous cache: the reference's "
            f"blockwise attention (S > {BLOCKWISE_THRESHOLD}, "
            "`_blockwise_id`) is not ported yet (ROADMAP item 9)")
    return S


def _leaf_to_torch(key: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()  # e.g. a read-only view of a JAX array; keeps 0-d
    t = torch.from_numpy(a).to(device)
    if key == "w_q" or key in EXPERT_WEIGHTS:
        # (.., K, N) values, stored (.., N, K) contiguous for the kernel
        # (transposed by torch: numpy's transposing copy is several
        # times slower, and on the card it runs on the device)
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t


def tree_to_torch(tree: dict, device, key: str = "") -> Any:
    """numpy table tree -> torch tree on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, k) for k, v in tree.items()}
    return _leaf_to_torch(key, tree, device)


def params_to_torch(tree, device="cuda"):
    """A numpy float param tree (`init_np`'s, or a reference tree carried
    across) -> float32 torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_torch(v, device) for v in tree]
    return _leaf_to_torch("", np.asarray(tree, np.float32), device)


def tables_to(tables, device):
    """A torch table tree (as `tables_from_numpy` or
    `launch.serve.deploy_model` return it) -> the same tree on
    `device`, strides kept (the GEMM's (N, K) weight layout)."""
    if isinstance(tables, dict):
        return {k: tables_to(v, device) for k, v in tables.items()}
    if isinstance(tables, list):
        return [tables_to(v, device) for v in tables]
    if isinstance(tables, torch.Tensor):
        return tables.to(device)
    return tables


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
    (`layers.attention.kv4_load`), and its `sm_tabs` scalars become 0-d
    int32 tensors of their own (`core.intsoftmax.int_softmax_load`), so
    the integer softmax reads them as device operands.  A Mamba layer's
    dt_proj weight is padded along K (`layers.ssm.load_core`)."""
    if "core" in t:
        return {**t, "core": load_core(t["core"])}
    attn = {**t["attn"], "kv4": kv4_load(t["attn"]["kv4"])}
    if "sm_tabs" in attn:
        attn["sm_tabs"] = int_softmax_load(attn["sm_tabs"])
    return {**t, "attn": attn}


def tables_from_numpy(tables_np: dict, device="cuda") -> dict:
    """A reference-deployed table tree (plain numpy, e.g. after
    `jax.tree.map(np.asarray, tables)`) -> the port's state on
    `device`.  int32 stays int32 (every requant table, the per-head
    `kv4` pack/unpack tables included), int8 stays int8 and the f32
    score_scale stays f32; `segments[0]` becomes the per-layer list,
    each layer through `load_layer`."""
    if len(tables_np["segments"]) != 1:
        raise ValueError("the dense, MoE (moe_every 1) and ssm families "
                         "have exactly one segment")
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
        c = self.cfg
        if c.input_mode != "tokens":
            raise NotImplementedError(
                f"input_mode {c.input_mode!r}: the port serves token LMs "
                "(the embeds frontends are ROADMAP item 10)")
        if c.family == "cnn":
            raise NotImplementedError(
                "the cnn family is not a decoder LM: its model is "
                "repro_torch.models.cnn.NemoCNN")
        if c.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"the {c.family} family is not ported yet (ROADMAP item 10)")
        if c.family == "moe" and c.moe_every != 1:
            raise NotImplementedError(
                f"moe_every {c.moe_every} (the reference's pair segments, "
                "llama4_maverick) is not ported yet (ROADMAP item 10)")
        if c.family == "moe" and c.shared_expert:
            raise NotImplementedError(
                "the shared expert (llama4_maverick) is not ported yet "
                "(ROADMAP item 10)")

    # -- structure -------------------------------------------------------
    @property
    def recurrent(self) -> bool:
        """Whether the cache is per-slot recurrent state (ssm) rather
        than KV pools."""
        return self.cfg.family == "ssm"

    def block(self):
        c = self.cfg
        if self.recurrent:
            return MambaBlock(d_model=c.d_model, ssm_kind=c.ssm_kind,
                              d_state=c.ssm_state, expand=c.ssm_expand,
                              norm=c.norm)
        moe = c.family == "moe"
        return DenseBlock(
            d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
            head_dim=c.hd, d_ff=c.d_ff, act=ACT_MAP[c.act], gated=c.gated,
            norm=c.norm, norm_bias=c.norm_bias, rope_base=c.rope_base,
            rope_fraction=c.rope_fraction, max_seq=self.max_seq,
            n_experts=c.n_experts if moe else 0, top_k=c.top_k,
            moe_group=c.moe_group,
        )

    def plan(self):
        """-> the segments (kind, template, n_steps): one segment of
        blocks, for dense and for MoE at moe_every 1, of Mamba blocks for
        ssm (the reference's `plan()` for those)."""
        kind = "mamba" if self.recurrent else "dense"
        return [(kind, self.block(), self.cfg.n_layers)]

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

    # -- float forward (FullPrecision, torch) -------------------------------
    # p: a float param tree already on the device (`params_to_torch`).
    def embed_in(self, p: dict, batch: torch.Tensor, calib=None):
        """tokens (B, S) -> (B, S, d) float32, observing "embed"."""
        return self.embed_layer().apply_fp(p["embed"], batch, calib, "")

    def apply_layer(self, p_layer: dict, i: int, x: torch.Tensor,
                    calib=None) -> torch.Tensor:
        """Layer i's float forward under its scope ``S0.L{i}.``."""
        return self.block().apply_float(p_layer, x, calib, f"S0.L{i}.")

    def apply(self, p: dict, x: torch.Tensor, calib=None) -> torch.Tensor:
        """(B, S, d) float -> the last layer's output, layer by layer."""
        seg = p["segments"][0]
        for i in range(self.cfg.n_layers):
            x = self.apply_layer(_index(seg, i), i, x, calib)
        return x

    def logits(self, p: dict, x: torch.Tensor, calib=None) -> torch.Tensor:
        """Final norm + float head; observes "final.norm" and
        "final.head_in"; padded vocab slots masked to -1e9."""
        c = self.cfg
        h = self.norm_f_layer().apply_fp(p["norm_f"], x, calib, "final.")
        if calib is not None:
            calib.observe("final.head_in", h)
        logits = self.head_layer().apply_fp(p["head"], h)
        if c.vocab_padded != c.vocab:
            pad = torch.arange(c.vocab_padded, device=logits.device) >= c.vocab
            logits = logits.masked_fill(pad, LOGIT_PAD_FP)
        return logits

    def calibrate(self, p, sample, *, device="cuda") -> Calibrator:
        """The FullPrecision forward of `sample` (B, S) tokens with
        every activation observed; `p` is the whole numpy float param
        tree, moved to `device` in float32."""
        calib = Calibrator()
        p = params_to_torch(p, device)
        tok = torch.from_numpy(np.array(sample)).to(device)
        x = self.embed_in(p, tok, calib)
        x = self.apply(p, x, calib)
        self.logits(p, x, calib)
        return calib

    # -- integer serving path (torch) --------------------------------------
    def init_state(self, B: int, device="cuda") -> dict:
        """The ssm family's zeroed cache of B slot rows, every layer's
        {"conv", "h"} stacked (`QMamba1.init_cache`)."""
        one = self.block()._subs()["core"].init_cache(B, device)
        return {k: v[None].repeat(self.cfg.n_layers, *([1] * v.dim()))
                for k, v in one.items()}

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

    def init_caches(self, B: int, max_len: int, device="cuda") -> dict:
        """The reference's contiguous ID cache of `B` slots of `max_len`
        positions, zeroed, as a pool of B pages of max_len positions plus
        the trash page, with the fixed table slot b -> page b + 1 (the
        ssm family: `init_state(B)`, whatever max_len)."""
        if self.recurrent:
            return self.init_state(B, device)
        caches = self.init_pools(B, max_len, device=device)
        caches["table"] = torch.arange(1, B + 1, dtype=torch.int32,
                                       device=device)[:, None]
        return caches

    def prefill(self, t: dict, batch: torch.Tensor, caches: dict,
                last_index=None) -> torch.Tensor:
        """ID prefill at position 0 of every row (the reference's
        `prefill`): fills `caches` in place; -> (B, 1, vocab_padded)
        int32 logits at column `last_index` (an int, or None: the last
        column)."""
        B, S = batch.shape
        if not self.recurrent:
            check_contiguous_width(S)
        start = torch.zeros(B, dtype=torch.int32, device=batch.device)
        last = torch.full_like(start, S - 1 if last_index is None
                               else int(last_index))
        return self.prefill_chunk(t, batch, caches, start, last)

    def decode_step(self, t: dict, token: torch.Tensor, caches: dict,
                    pos: torch.Tensor) -> torch.Tensor:
        """ID single-token decode (the reference's `decode_step`): token
        (B, 1) at per-row positions pos (B,) int32; -> (B, 1,
        vocab_padded) int32 logits."""
        return self.prefill_chunk(t, token, caches, pos, torch.zeros_like(pos))

    def prefill_chunk(self, t: dict, batch: torch.Tensor, caches: dict,
                      start_pos: torch.Tensor,
                      last_index: torch.Tensor) -> torch.Tensor:
        """ID batched + chunked prefill over the paged arena (or the
        contiguous caches, read as pages).

        batch (B, C) int32 tokens (one chunk per slot row; decode rows
        are width-1 chunks); start_pos (B,) int32 position of each
        row's first token (INACTIVE_POS for parked rows); last_index
        (B,) int32 column whose logits to return.  Writes every row's
        K/V into `caches` in place.  -> (B, 1, vocab_padded) int32.

        The ssm family: `caches` is `init_state`'s; every row runs its
        chunk after its state, parked rows too (positions do not
        enter), and the state advances in place."""
        x = self.embed_in_id(t, batch)
        blk = self.block()
        if self.recurrent:
            for i, lt in enumerate(t["layers"]):
                x = blk.apply_id(lt, x, {"conv": caches["conv"][i],
                                         "h": caches["h"][i]})
            return self._last_logits(t, x, last_index)
        table = caches["table"]
        for i, lt in enumerate(t["layers"]):
            cache_i = {"k": caches["k"][i], "v": caches["v"][i],
                       "table": table}
            x = blk.apply_id(lt, x, cache_i, start_pos)
        return self._last_logits(t, x, last_index)

    def _last_logits(self, t: dict, x: torch.Tensor,
                     last_index: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(x.shape[0], device=x.device)
        h = x[rows, last_index.to(torch.int64)][:, None, :]
        return self.logits_id(t, h)
