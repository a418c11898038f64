"""The decoder LM (port of `repro.models.lm.DecoderLM`, the dense, MoE,
ssm and hybrid families: `plan()` is one segment of `DenseBlock`s, with
a `QMoE` in every block for MoE at `moe_every` 1, one segment of
"pair"s for MoE at `moe_every` 2 (llama4_maverick: a dense block, then
a MoE block with its shared expert; block i is the pair's "a" for even
i, its "b" for odd i, scopes `S0.L{i // 2}.a.` / `.b.`), one segment of
`MambaBlock`s for ssm, and for the hybrid (zamba2) a segment of groups
of `shared_attn_every` Mamba-2 blocks each followed by one application
of the `SharedAttnBlock`, then a segment of the remaining Mamba-2
blocks).

Lifecycle, as the reference's: numpy init (`init_np`, the reference's
shapes and scales) -> calibrate (`calibrate`: the FullPrecision
forward `embed_in` -> `apply` -> `logits` in float32 on the device,
observing every activation range under the reference's names) ->
host-side deploy (`deploy(p, calib)`, the reference's integer tables
leaf for leaf, the integer softmax's `sm_tabs` included;
`deploy(p, None)` is the calibration-free deploy on DEFAULT_RANGES)
-> torch state (`tables_from_numpy`) -> ID apply (`prefill_chunk`, a
Python loop over the layers where the reference runs `lax.scan`).
The float forward (`apply`) is the reference's per-layer walk (scopes
`S0.L{i}.`; the hybrid's `S0.L{g}.m{j}.`, `S0.L{g}.sh.` and
`S1.L{i}.`, the shared block reading x0, the embedding's output);
with float caches (`init_caches(B, T, Rep.FP)`, the reference's bf16
layout) it threads them through the segments (`apply_cached`, the
reference's `_seg_scan` with caches).  It runs FullPrecision and
FakeQuantized
(`rep=Rep.FQ` with the PACT clips of `init_qstate`) for every family,
under autograd with the reference's rematerialisation (each layer of a
dense, MoE or ssm segment of more than one layer; each group of the
hybrid, its blocks and its shared application); `apply_with_aux` also
returns the MoE layers' summed load-balancing loss.  `loss_fn` and
`loss_fn_embeds` are the reference's training losses (bfloat16
activations, float32 params and logits, + 0.01 aux), which
`launch.train` and `launch.steps` differentiate.

An embeds model (`input_mode="embeds"`, internvl2_76b) has no
embedding table: its float forward takes (B, S, d) float embeddings,
its deploy takes their quantum `eps_in` (default 2 * 8 / 255), and
`prefill` / `decode_step` / `prefill_chunk` take (B, C, d) int8 rows at
that quantum where a token model takes (B, C) ids.

Port state layout (what `tables_from_numpy` returns):

    {"meta": {...}, "embed": {...} (token models), "layers": [layer 0
     tables, ...],
     "norm_f": {...}, "head": {...}}

i.e. the reference tree with its layer-stacked `segments[0]` split into
a per-layer list (views into the stacked tensors when converted from a
stacked tree; a pair segment's {"a", "b"} interleaved, a0 b0 a1 b1 ...,
so KV pool i is block i's).  The hybrid's "layers" are its Mamba-2
blocks in the order they run (group g's block j at g *
shared_attn_every + j, then the tail), and "shared" holds one table set
per application of the
shared block (the reference's `segments[0]["sh"]`); `steps()` gives
the walk.  Every dtype is the reference's; every QLinear weight
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
for every row, parked rows included, as the reference's does.  The
hybrid's cache holds both: the state of each of its n_layers Mamba-2
blocks ({"conv": (.., d_conv_in) int8, "h": (n_layers, B, H, P,
d_state) float32}) and KV pools of one layer a shared application
(`n_kv_layers`, the number of groups).  A contiguous cache
(`init_caches`) carries ``"contiguous": True``, which the attention
reads to take the reference's dense-branch path above 4096 rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.intsoftmax import int_softmax_load
from repro_torch.core.rep import Rep
from repro_torch.layers.attention import kv4_load, kv4_shard
from repro_torch.layers.common import ActKind, DeployCtx, stack_trees
from repro_torch.layers.embedding import QEmbed
from repro_torch.layers.linear import QLinear
from repro_torch.layers.moe import EXPERT_WEIGHTS
from repro_torch.layers.norms import QNorm
from repro_torch.layers.ssm import load_core
from repro_torch.models.blocks import DenseBlock, MambaBlock, SharedAttnBlock

ACT_MAP = {"silu": ActKind.SILU, "gelu": ActKind.GELU, "relu": ActKind.RELU,
           "relu2": ActKind.RELU2}
LOGIT_PAD = -(2 ** 30)  # integer mask for padded vocab slots
LOGIT_PAD_FP = -1e9  # the float forward's mask for padded vocab slots
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


def _unbind(tree) -> list:
    """A layer-stacked torch tree -> its per-layer trees (views; the
    backward of `unbind` stacks the layers' gradients at once)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _restack(stacked: dict, per: list) -> dict:
    """A segment's cache after its layers ran: the K/V leaves (and a
    page table) are the stacked tensors, written in place through the
    layers' views; every other entry (the Mamba state, new tensors a
    layer) is stacked anew from the layers' dicts."""
    out = {}
    for k, v in stacked.items():
        if isinstance(v, dict):
            out[k] = _restack(v, [c[k] for c in per])
        elif k in ("k", "v", "table"):
            out[k] = v
        else:
            out[k] = torch.stack([c[k] for c in per])
    return out


def _run(fn, remat: bool, *args):
    """fn(*args), rematerialised in the backward pass when `remat`."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _n_stacked(tree) -> int:
    return len(next(iter(_leaves(tree))))


KV_BITS = (8, 4)  # KV storage widths: int8 images or int4-packed pairs


def check_kv_bits(kv_bits: int) -> int:
    """The one check of a KV storage width (`init_pools`, and
    `serving.config.ServingConfig` at construction)."""
    if kv_bits not in KV_BITS:
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    return kv_bits


def load_layer(t: dict) -> dict:
    """One layer's (or shared application's) torch tables -> its
    serving state: the attention's `kv4` tables gain what every step
    would otherwise rebuild (`layers.attention.kv4_load`), and its
    `sm_tabs` scalars become 0-d int32 tensors of their own
    (`core.intsoftmax.int_softmax_load`), so the integer softmax reads
    them as device operands.  A Mamba-1 layer's dt_proj weight is
    padded along K (`layers.ssm.load_core`)."""
    if "core" in t:
        t = {**t, "core": load_core(t["core"])}
    if "attn" in t:
        attn = {**t["attn"], "kv4": kv4_load(t["attn"]["kv4"])}
        if "sm_tabs" in attn:
            attn["sm_tabs"] = int_softmax_load(attn["sm_tabs"])
        t = {**t, "attn": attn}
    return t


def shard_tables(tables: dict, kr: slice) -> dict:
    """Served tables (`tables_from_numpy`) for a kv-sharded rank whose
    pools hold the kv heads `kr`: every attention's `kv4` tables cut to
    those heads (`layers.attention.kv4_shard`), the hybrid's shared
    applications too; every other table is shared with `tables`."""
    def cut(t):
        if "attn" not in t:
            return t
        attn = t["attn"]
        return {**t, "attn": {**attn, "kv4": kv4_shard(attn["kv4"], kr)}}

    out = dict(tables, layers=[cut(t) for t in tables["layers"]])
    if "shared" in tables:
        out["shared"] = [cut(t) for t in tables["shared"]]
    return out


def tables_from_numpy(tables_np: dict, device="cuda") -> dict:
    """A reference-deployed table tree (plain numpy, e.g. after
    `jax.tree.map(np.asarray, tables)`) -> the port's state on
    `device`.  int32 stays int32 (every requant table, the per-head
    `kv4` pack/unpack tables included), int8 stays int8 and the f32
    score_scale stays f32; the stacked segments become the per-layer
    list (the hybrid's group blocks in order, then its tail; a pair
    segment's blocks interleaved) and, for
    the hybrid, the per-application "shared" list, each entry through
    `load_layer`."""
    segs = [tree_to_torch(seg, device) for seg in tables_np["segments"]]
    layers, shared = [], []
    if segs and isinstance(segs[0], dict) and set(segs[0]) == {"m", "sh"}:
        hyb = segs.pop(0)
        for g in range(_n_stacked(hyb["sh"])):
            m = _index(hyb["m"], g)
            layers += [_index(m, j) for j in range(_n_stacked(m))]
            shared.append(load_layer(_index(hyb["sh"], g)))
    elif len(segs) != 1:
        raise ValueError("the dense, MoE and ssm families have exactly one "
                         "segment")
    for seg in segs:
        if set(seg) == {"a", "b"}:  # pairs, interleaved in walk order
            for i in range(_n_stacked(seg["a"])):
                layers += [_index(seg["a"], i), _index(seg["b"], i)]
        else:
            layers += [_index(seg, i) for i in range(_n_stacked(seg))]
    out = {
        "meta": {k: float(np.asarray(v)) for k, v in
                 tables_np.get("meta", {}).items()},
        "layers": [load_layer(t) for t in layers],
        "norm_f": tree_to_torch(tables_np["norm_f"], device),
        "head": tree_to_torch(tables_np["head"], device),
    }
    if "embed" in tables_np:
        out["embed"] = tree_to_torch(tables_np["embed"], device)
    if shared:
        out["shared"] = shared
    return out


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
        if c.input_mode not in ("tokens", "embeds"):
            raise ValueError(f"unknown input_mode {c.input_mode!r}")
        if c.family == "cnn":
            raise NotImplementedError(
                "the cnn family is not a decoder LM: its model is "
                "repro_torch.models.cnn.NemoCNN")
        if c.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"unknown family {c.family!r}")
        if c.family == "moe" and c.moe_every not in (1, 2):
            raise ValueError(f"moe_every {c.moe_every}: the reference plans "
                             "MoE segments at moe_every 1 or 2")
        if self.pair and c.n_layers % 2:
            raise ValueError(f"moe_every 2 pairs the blocks: n_layers "
                             f"{c.n_layers} must be even")

    # -- structure -------------------------------------------------------
    @property
    def pair(self) -> bool:
        """Whether the blocks run in pairs, dense then MoE (moe_every
        2)."""
        return self.cfg.family == "moe" and self.cfg.moe_every == 2

    @property
    def recurrent(self) -> bool:
        """Whether the cache holds per-slot recurrent state (ssm,
        hybrid)."""
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def has_kv(self) -> bool:
        """Whether the cache holds KV pools (all but ssm)."""
        return self.cfg.family != "ssm"

    @property
    def groups(self) -> int:
        """The hybrid's shared-attention applications (0 otherwise)."""
        c = self.cfg
        return c.n_layers // c.shared_attn_every if (
            c.family == "hybrid") else 0

    @property
    def n_kv_layers(self) -> int:
        """Layers of KV pools: one a block for dense and MoE, one a
        shared application for the hybrid."""
        return self.groups if self.cfg.family == "hybrid" else (
            self.cfg.n_layers if self.has_kv else 0)

    def block(self, i: int = 0):
        """The template of block i (every block's but in pairs, where
        even i is the dense block and odd i the MoE block with its
        shared expert; the hybrid's Mamba-2 block)."""
        c = self.cfg
        if self.recurrent:
            return MambaBlock(d_model=c.d_model, ssm_kind=c.ssm_kind,
                              d_state=c.ssm_state, expand=c.ssm_expand,
                              head_dim=c.ssm_head_dim, norm=c.norm)
        moe = c.family == "moe" and not (self.pair and i % 2 == 0)
        return DenseBlock(
            d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
            head_dim=c.hd, d_ff=c.d_ff, act=ACT_MAP[c.act], gated=c.gated,
            norm=c.norm, norm_bias=c.norm_bias, rope_base=c.rope_base,
            rope_fraction=c.rope_fraction, max_seq=self.max_seq,
            n_experts=c.n_experts if moe else 0, top_k=c.top_k,
            moe_group=c.moe_group, shared_expert=c.shared_expert and moe,
        )

    def shared_block(self) -> SharedAttnBlock:
        c = self.cfg
        return SharedAttnBlock(d_model=c.d_model, n_heads=c.n_heads,
                               n_kv_heads=c.n_kv_heads, head_dim=c.hd,
                               max_seq=self.max_seq, norm=c.norm)

    def plan(self):
        """-> the segments (kind, template, n_steps), the reference's
        `plan()`: one segment of blocks for dense and MoE at moe_every
        1, of (dense, MoE) pairs at moe_every 2, of Mamba blocks for
        ssm; for the hybrid the groups, then the tail of Mamba blocks if
        any."""
        c = self.cfg
        if self.pair:
            return [("pair", (self.block(0), self.block(1)),
                     c.n_layers // 2)]
        if c.family == "hybrid":
            k = c.shared_attn_every
            groups, tail = divmod(c.n_layers, k)
            segs = [("hybrid", (self.block(), self.shared_block()), groups)]
            if tail:
                segs.append(("mamba", self.block(), tail))
            return segs
        kind = "mamba" if self.recurrent else "dense"
        return [(kind, self.block(), c.n_layers)]

    def steps(self):
        """The walk of every forward: ("layer", i) for block i (in the
        order they run) and, for the hybrid, ("shared", g) after each
        group g of shared_attn_every blocks."""
        c = self.cfg
        k = c.shared_attn_every if c.family == "hybrid" else 0
        out = []
        for i in range(c.n_layers):
            out.append(("layer", i))
            if k and (i + 1) % k == 0 and (i + 1) // k <= self.groups:
                out.append(("shared", (i + 1) // k - 1))
        return out

    def layer_scope(self, i: int) -> str:
        """Block i's calibration scope, the reference's."""
        c = self.cfg
        if self.pair:
            return f"S0.L{i // 2}.{'ab'[i % 2]}."
        if c.family != "hybrid":
            return f"S0.L{i}."
        g, j = divmod(i, c.shared_attn_every)
        if g < self.groups:
            return f"S0.L{g}.m{j}."
        return f"S1.L{i - self.groups * c.shared_attn_every}."

    @staticmethod
    def shared_scope(g: int) -> str:
        return f"S0.L{g}.sh."

    def _segments(self, layers: list, shared: list = ()) -> list:
        """Per-block trees (and the hybrid's per-application shared
        trees) -> the reference's stacked `segments`."""
        c = self.cfg
        if self.pair:
            return [{"a": stack_trees(layers[0::2]),
                     "b": stack_trees(layers[1::2])}]
        if c.family != "hybrid":
            return [stack_trees(layers)]
        k, G = c.shared_attn_every, self.groups
        grp = []
        for g in range(G):
            one = {"m": stack_trees(layers[g * k:(g + 1) * k])}
            if shared:
                one["sh"] = shared[g]
            grp.append(one)
        segs = [stack_trees(grp)]
        if c.n_layers > G * k:
            segs.append(stack_trees(layers[G * k:]))
        return segs

    def layer_params(self, p: dict, i: int) -> dict:
        """Block i's float params out of the reference's layout."""
        c = self.cfg
        if self.pair:
            return _index(p["segments"][0]["ab"[i % 2]], i // 2)
        if c.family != "hybrid":
            return _index(p["segments"][0], i)
        g, j = divmod(i, c.shared_attn_every)
        if g < self.groups:
            return _index(_index(p["segments"][0]["m"], g), j)
        return _index(p["segments"][1], i - self.groups * c.shared_attn_every)

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
        return self.block(i).init_np(np.random.default_rng([seed, 1, i]))

    def init_head_np(self, seed: int) -> Tuple[dict, dict]:
        """-> (final norm params, head params)."""
        rng = np.random.default_rng([seed, 2])
        return self.norm_f_layer().init_np(), self.head_layer().init_np(rng)

    def init_shared_np(self, seed: int) -> dict:
        """The hybrid's one float weight set of the shared block."""
        return self.shared_block().init_np(np.random.default_rng([seed, 3]))

    def init_np(self, seed: int) -> dict:
        """The whole float param tree in the reference's layout
        (layer-stacked segments; the hybrid's `shared_attn`; no
        embedding table for an embeds model)."""
        p: Dict[str, Any] = {}
        if self.cfg.input_mode == "tokens":
            p["embed"] = self.init_embed_np(seed)
        p["segments"] = self._segments(
            [self.init_layer_np(seed, i) for i in range(self.cfg.n_layers)])
        p["norm_f"], p["head"] = self.init_head_np(seed)
        if self.groups:
            p["shared_attn"] = self.init_shared_np(seed)
        return p

    # -- deploy (host, numpy) --------------------------------------------
    def deploy_embed(self, ctx: DeployCtx, p_embed: dict):
        """-> (embed tables, eps of the first residual image)."""
        t, eps_x, _ = self.embed_layer().deploy(ctx, p_embed)
        return t, eps_x

    def deploy_layer(self, ctx: DeployCtx, i: int, p_layer: dict,
                     eps_x: float) -> Tuple[dict, float]:
        return self.block(i).deploy(ctx, self.layer_scope(i), p_layer,
                                    eps_x)

    def deploy_shared(self, ctx: DeployCtx, g: int, p_shared: dict,
                      eps_x: float, eps_in: float) -> Tuple[dict, float]:
        """Shared application g's own tables (x0's quantum is the
        embedding's, `eps_in`)."""
        return self.shared_block().deploy(ctx, self.shared_scope(g),
                                          p_shared, eps_x, eps_in)

    def deploy_head(self, ctx: DeployCtx, p_norm: dict, p_head: dict,
                    eps_x: float):
        """-> (norm_f tables, head tables, eps_logits)."""
        tn, eps_h, _ = self.norm_f_layer().deploy(ctx, "final.", p_norm, eps_x)
        th, eps_logits = self.head_layer().deploy(p_head, eps_h, 0)
        return tn, th, float(np.max(eps_logits))

    def deploy(self, p, calib=None, *, factor: int = 256,
               eps_in: Optional[float] = None) -> dict:
        """-> integer tables in the reference's layout (numpy).  An
        embeds model has no table: its input rows are int8 images at
        `eps_in` (default 2 * 8 / 255, zero point 0), which
        `meta["eps_in"]` records as it records the embedding's quantum
        otherwise."""
        ctx = DeployCtx(calib=calib, factor=factor)
        t: Dict[str, Any] = {"meta": {}}
        if self.cfg.input_mode == "tokens":
            t["embed"], eps_x = self.deploy_embed(ctx, p["embed"])
        else:
            eps_x = eps_in or (2.0 * 8.0 / 255.0)
        eps_in = t["meta"]["eps_in"] = eps_x
        layers, shared = [], []
        for kind, i in self.steps():
            if kind == "layer":
                ti, eps_x = self.deploy_layer(ctx, i, self.layer_params(p, i),
                                              eps_x)
                layers.append(ti)
            else:
                ti, eps_x = self.deploy_shared(ctx, i, p["shared_attn"],
                                               eps_x, eps_in)
                shared.append(ti)
        t["segments"] = self._segments(layers, shared)
        t["norm_f"], t["head"], t["meta"]["eps_logits"] = self.deploy_head(
            ctx, p["norm_f"], p["head"], eps_x)
        return t

    # -- float forward (FullPrecision and FakeQuantized, torch) -----------
    # p: a float param tree already on the device (`params_to_torch`).
    def embed_in(self, p: dict, batch: torch.Tensor, rep: Rep = Rep.FP,
                 calib=None) -> torch.Tensor:
        """tokens (B, S) -> (B, S, d) float32 (at FP observing "embed";
        at FQ through the PACT-restricted table); an embeds model's
        (B, S, d) float batch passes through, as the reference's."""
        if self.cfg.input_mode == "embeds":
            return batch
        return self.embed_layer().apply(p["embed"], batch, rep, calib=calib)

    def apply_layer(self, p_layer: dict, i: int, x: torch.Tensor,
                    calib=None, *, rep: Rep = Rep.FP, qs=None,
                    aux: Optional[list] = None, cache: Optional[dict] = None,
                    pos=None) -> torch.Tensor:
        """Block i's float forward under its scope (its clips ``qs`` at
        FQ; a MoE block appends its aux loss to ``aux``; its float
        `cache` at `pos`)."""
        return self.block(i).apply_float(p_layer, x, calib,
                                         self.layer_scope(i), rep=rep,
                                         qs=qs, aux=aux, cache=cache,
                                         pos=pos)

    def apply_shared(self, p_shared: dict, g: int, x: torch.Tensor,
                     x0: torch.Tensor, calib=None, *, rep: Rep = Rep.FP,
                     cache: Optional[dict] = None,
                     pos=None) -> torch.Tensor:
        """Shared application g's float forward over concat(x, x0)."""
        return self.shared_block().apply_float(p_shared, x, x0, calib,
                                               self.shared_scope(g), rep=rep,
                                               cache=cache, pos=pos)

    def init_qstate(self, device="cuda") -> dict:
        """The FQ clips (PACT's learnable alpha / beta) in the
        reference's layout (its `plan()`): a dense or MoE segment's
        {"mlp" | "moe": {"alpha": (L,), "beta": (L,)}} (a MoE block
        with a shared expert has both), stacked over the layers as the
        params are, a pair segment's {"a": .., "b": ..} of n pairs, and
        {} for each mamba and hybrid segment, so a train state, its
        moments and its checkpoints are the reference's leaf for leaf;
        block i's are `_index(qs, i)` of the segment (of its half for a
        pair).  A reference qstate carries across through
        `params_to_torch`."""

        def stack(v, n):
            if isinstance(v, dict):
                return {k: stack(u, n) for k, u in v.items()}
            return v.expand(n).clone()

        def seg(kind, tpl, n):
            if kind == "dense":
                return stack(tpl.init_qstate(device), n)
            if kind == "pair":
                return {h: stack(t.init_qstate(device), n)
                        for h, t in zip("ab", tpl)}
            return {}

        return {"segments": [seg(*s) for s in self.plan()]}

    def apply(self, p: dict, x: torch.Tensor, rep: Rep = Rep.FP, *,
              qstate=None, calib=None, caches=None, pos=None):
        """(B, S, d) float -> the last layer's output (`apply_with_aux`
        without the aux loss); with float `caches` (`init_caches(B, T,
        Rep.FP)`) -> (the output, the new caches), the rows at `pos`
        (`apply_cached`)."""
        if caches is not None:
            return self.apply_cached(p, x, rep, caches, pos, qstate=qstate,
                                     calib=calib)
        return self.apply_with_aux(p, x, rep, qstate=qstate,
                                   calib=calib)[0]

    def apply_cached(self, p: dict, x: torch.Tensor, rep: Rep, caches: list,
                     pos, *, qstate=None, calib=None):
        """The float forward through the reference's float caches (its
        `_seg_scan` with caches): each segment's stacked cache handed to
        its blocks layer by layer, the hybrid's group g's Mamba-2 blocks
        and its shared application their own rows.  The attention caches
        are written in place (the returned tree holds the same K/V
        tensors); the Mamba state comes back as new stacked tensors.
        -> (output, new caches), a list a segment.

        With a calibrator the reference walks the segments eagerly and
        gives no cache for the hybrid's segment (its eager walk reads
        the group's cache under the wrong keys and raises); the port
        runs the same walk with each block's own cache, observing, and
        returns None for that segment, as the reference means to."""
        if rep is Rep.ID:
            raise ValueError("the integer forward is prefill_chunk's")
        segs_qs = qstate["segments"] if qstate else None
        x0, i0, out = x, 0, []
        for si, (kind, _, n) in enumerate(self.plan()):
            seg, sc = p["segments"][si], caches[si]
            if kind == "hybrid":
                k = self.cfg.shared_attn_every
                groups = []
                for g in range(n):
                    p_g = _index(seg["m"], g)
                    m_g = _index(sc["m"], g)
                    per = []
                    for j in range(k):
                        c_j = _index(m_g, j)
                        x = self.apply_layer(_index(p_g, j), g * k + j, x,
                                             calib, rep=rep, cache=c_j,
                                             pos=pos)
                        per.append(c_j)
                    groups.append(_restack(m_g, per))
                    x = self.apply_shared(p["shared_attn"], g, x, x0, calib,
                                          rep=rep, cache=_index(sc["sh"], g),
                                          pos=pos)
                out.append(None if calib is not None else
                           {"m": _restack(sc["m"], groups), "sh": sc["sh"]})
                i0 += n * k
                continue
            seg_qs = segs_qs[si] if segs_qs else None
            if kind == "pair":
                # (n, 2, B, ...): pair j's dense block on row 0, MoE on 1
                for j in range(n):
                    c_j = _index(sc, j)
                    for h, half in enumerate("ab"):
                        x = self.apply_layer(
                            _index(seg[half], j), 2 * j + h, x, calib,
                            rep=rep, cache=_index(c_j, h), pos=pos,
                            qs=_index(seg_qs[half], j) if seg_qs else None)
                out.append(sc)
                i0 += 2 * n
                continue
            per = []
            for j in range(n):
                c_j = _index(sc, j)
                x = self.apply_layer(
                    _index(seg, j), i0 + j, x, calib, rep=rep,
                    qs=_index(seg_qs, j) if seg_qs else None, cache=c_j,
                    pos=pos)
                per.append(c_j)
            out.append(_restack(sc, per))
            i0 += n
        return x, out

    def apply_with_aux(self, p: dict, x: torch.Tensor, rep: Rep = Rep.FP,
                       *, qstate=None, calib=None):
        """(B, S, d) float -> (the last layer's output, the MoE layers'
        aux losses summed in layer order, a float32 0-d tensor: 0 for
        the other families), walking the reference's segments.

        At FP with a calibrator this is the reference's eager walk,
        observing every layer under its scope.  Otherwise, with
        gradients on, the reference's scan bodies are rematerialised in
        the backward pass (`torch.utils.checkpoint`, as `jax.checkpoint`
        does there): each layer of a dense, MoE or mamba segment when
        the model has more than one layer, and each hybrid group (its
        blocks and shared application) always.  The stacked layer
        params (and clips) are split with `unbind`, whose backward is
        one stack a leaf; the shared weights' gradient sums over their
        applications.  A pair (its dense and MoE block) is one
        rematerialised unit, as the reference's pair scan body is."""
        if rep is Rep.ID:
            raise ValueError("the integer forward is prefill_chunk's")
        remat = calib is None and torch.is_grad_enabled()
        deep = self.cfg.n_layers > 1
        segs_qs = qstate["segments"] if qstate else None
        x0, aux, i0 = x, None, 0
        for si, (kind, _, n) in enumerate(self.plan()):
            seg = p["segments"][si]
            if kind == "hybrid":
                k = self.cfg.shared_attn_every
                for g, p_g in enumerate(_unbind(seg["m"])):
                    fn = self._group_fn(g, rep, calib)
                    x = _run(fn, remat, _unbind(p_g), p["shared_attn"], x,
                             x0)
                i0 += n * k
                continue
            seg_qs = segs_qs[si] if segs_qs else None
            qs = _unbind(seg_qs) if seg_qs else [None] * n
            for j, (p_j, qs_j) in enumerate(zip(_unbind(seg), qs)):
                if kind == "pair":
                    fn, rm = self._pair_fn(j, rep, calib), remat
                else:
                    fn, rm = self._layer_fn(i0 + j, rep, calib), remat and deep
                x, a = _run(fn, rm, p_j, qs_j, x)
                if a is not None:
                    aux = a if aux is None else aux + a
            i0 += 2 * n if kind == "pair" else n
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def _layer_fn(self, i: int, rep: Rep, calib):
        def run(p_i, qs_i, x):
            acc: list = []
            x = self.apply_layer(p_i, i, x, calib, rep=rep, qs=qs_i,
                                 aux=acc)
            return x, (acc[0] if acc else None)
        return run

    def _pair_fn(self, j: int, rep: Rep, calib):
        def run(p_j, qs_j, x):
            acc: list = []
            for h, half in enumerate("ab"):
                x = self.apply_layer(p_j[half], 2 * j + h, x, calib,
                                     rep=rep, aux=acc,
                                     qs=qs_j[half] if qs_j else None)
            return x, (acc[0] if acc else None)
        return run

    def _group_fn(self, g: int, rep: Rep, calib):
        k = self.cfg.shared_attn_every

        def run(p_blocks, p_shared, x, x0):
            for j, p_j in enumerate(p_blocks):
                x = self.apply_layer(p_j, g * k + j, x, calib, rep=rep)
            return self.apply_shared(p_shared, g, x, x0, calib, rep=rep)
        return run

    def logits(self, p: dict, x: torch.Tensor, rep: Rep = Rep.FP,
               calib=None) -> torch.Tensor:
        """Final norm + float head (at FQ on the PACT-restricted head);
        observes "final.norm" and "final.head_in"; padded vocab slots
        masked to -1e9; in x's dtype."""
        c = self.cfg
        h = self.norm_f_layer().apply_fp(p["norm_f"], x, calib, "final.")
        if calib is not None:
            calib.observe("final.head_in", h)
        logits = self.head_layer().apply(p["head"], h, rep)
        if c.vocab_padded != c.vocab:
            pad = torch.arange(c.vocab_padded, device=logits.device) >= c.vocab
            logits = logits.masked_fill(pad, LOGIT_PAD_FP)
        return logits

    def _nll(self, p: dict, x: torch.Tensor, tgt: torch.Tensor,
             rep: Rep, qstate) -> torch.Tensor:
        x, aux = self.apply_with_aux(p, x, rep, qstate=qstate)
        logits = self.logits(p, x, rep).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt.to(torch.int64)[..., None])[..., 0]
        # + 0.01 * the MoE's aux loss at every float rep (0 elsewhere)
        return torch.mean(nll) + 0.01 * aux

    def loss_fn(self, p: dict, qstate, tokens: torch.Tensor,
                rep: Rep) -> torch.Tensor:
        """Next-token cross entropy (+ 0.01 aux), tokens (B, S + 1): the
        reference's mixed precision (float32 params, the embedding's
        output cast to bfloat16, float32 logits into log_softmax)."""
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        x = self.embed_in(p, inp, rep).to(torch.bfloat16)
        return self._nll(p, x, tgt, rep, qstate)

    def loss_fn_embeds(self, p: dict, qstate, embeds: torch.Tensor,
                       tgt: torch.Tensor, rep: Rep) -> torch.Tensor:
        """Cross entropy of given embeddings (B, S, d), cast to bfloat16,
        against targets (B, S)."""
        return self._nll(p, embeds.to(torch.bfloat16), tgt, rep, qstate)

    def calibrate(self, p, sample, *, device="cuda") -> Calibrator:
        """The FullPrecision forward of `sample` with every activation
        observed: (B, S) tokens, or an embeds model's (B, S, d) float
        embeddings; `p` is the whole numpy float param tree, moved to
        `device` in float32."""
        calib = Calibrator()
        p = params_to_torch(p, device)
        if self.cfg.input_mode == "embeds":
            batch = torch.from_numpy(np.asarray(sample, np.float32))
        else:
            batch = torch.from_numpy(np.array(sample))
        x = self.embed_in(p, batch.to(device), calib=calib)
        x = self.apply(p, x, calib=calib)
        self.logits(p, x, calib=calib)
        return calib

    # -- integer serving path (torch) --------------------------------------
    def init_state(self, B: int, device="cuda") -> dict:
        """The recurrent families' zeroed state of B slot rows, every
        Mamba block's {"conv", "h"} stacked (`init_cache`)."""
        one = self.block().init_cache(B, device)
        return {k: v[None].repeat(self.cfg.n_layers, *([1] * v.dim()))
                for k, v in one.items()}

    def init_pools(self, n_pages: int, page_size: int, device="cuda",
                   kv_bits: int = 8, kv_heads: Optional[int] = None) -> dict:
        """Zeroed paged KV pools of `n_kv_layers` layers (page 0 is the
        PAGE_NULL trash page) holding `kv_heads` kv heads (all of them
        by default; a kv-sharded rank's range otherwise); at kv_bits 4
        the trailing head_dim axis is halved (packed)."""
        c = self.cfg
        hd = c.hd
        if check_kv_bits(kv_bits) == 4:
            if hd % 2:
                raise ValueError(f"kv_bits=4 needs an even head_dim, got {hd}")
            hd //= 2
        K = c.n_kv_heads if kv_heads is None else kv_heads
        shape = (self.n_kv_layers, n_pages + 1, K, page_size, hd)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
        }

    def embed_in_id(self, t: dict, batch: torch.Tensor) -> torch.Tensor:
        """tokens (B, C) -> their int8 rows; an embeds model's int8 (B,
        C, d) rows (images at meta["eps_in"], zero point 0) pass
        through."""
        if self.cfg.input_mode == "embeds":
            return batch
        return self.embed_layer().apply_id(t["embed"], batch)

    def logits_id(self, t: dict, s_x: torch.Tensor) -> torch.Tensor:
        """Final norm + int32 head; padded vocab slots masked."""
        c = self.cfg
        h = self.norm_f_layer().apply_id(t["norm_f"], s_x)
        logits = self.head_layer().apply_id(t["head"], h)
        if c.vocab_padded != c.vocab:
            pad = torch.arange(c.vocab_padded, device=logits.device) >= c.vocab
            logits = logits.masked_fill(pad, LOGIT_PAD)
        return logits

    def init_caches(self, B: int, max_len: int, rep: Rep = Rep.ID,
                    dtype=None, *, device="cuda",
                    kv_heads: Optional[int] = None):
        """The zeroed cache of `B` slots of `max_len` positions.

        At Rep.ID the port's contiguous ID cache: KV pools of B pages of
        max_len positions plus the trash page (of `kv_heads` kv heads,
        `init_pools`), with the fixed table slot b -> page b + 1 and
        ``"contiguous": True``; the recurrent families' state of B rows
        (`init_state`); the hybrid both.

        At FP / FQ the reference's float layout (`_float_caches`), a
        list of one tree a segment, the K/V and conv windows in `dtype`
        (bfloat16 by default), every SSM state h float32."""
        if rep is not Rep.ID:
            return self._float_caches(B, max_len, dtype or torch.bfloat16,
                                      device)
        caches = self.init_state(B, device) if self.recurrent else {}
        if self.has_kv:
            caches.update(self.init_pools(B, max_len, device=device,
                                          kv_heads=kv_heads))
            caches["table"] = torch.arange(1, B + 1, dtype=torch.int32,
                                           device=device)[:, None]
            caches["contiguous"] = True
        return caches

    def _float_caches(self, B: int, max_len: int, dtype, device) -> list:
        """The reference's `init_caches` at FP / FQ: a dense segment's
        {"k", "v": (n, B, K, max_len, hd)} (a pair segment's (n, 2, B,
        ...), its dense block's on row 0), a mamba segment's {"conv":
        (n, B, conv_k - 1, channels), "h": (n, B, ...) float32}, the
        hybrid's {"m": the Mamba-2 state (G, k, B, ...), "sh": the
        shared applications' K/V (G, B, K, max_len, hd)}."""
        def stack(tree, n):
            return {k: (stack(v, n) if isinstance(v, dict) else
                        v[None].repeat(n, *([1] * v.dim())))
                    for k, v in tree.items()}

        rep = Rep.FP
        out = []
        for kind, tpl, n in self.plan():
            if kind == "dense":
                out.append(stack(tpl.init_cache(B, max_len, dtype, device),
                                 n))
            elif kind == "pair":
                one = stack(tpl[0].init_cache(B, max_len, dtype, device), 2)
                out.append(stack(one, n))
            elif kind == "mamba":
                out.append(stack(tpl.init_cache(B, device, rep, dtype), n))
            else:
                mam, sha = tpl
                k = self.cfg.shared_attn_every
                one = {"m": stack(mam.init_cache(B, device, rep, dtype), k),
                       "sh": sha.init_cache(B, max_len, dtype, device)}
                out.append(stack(one, n))
        return out

    def prefill(self, t: dict, batch: torch.Tensor, caches: dict,
                last_index=None) -> torch.Tensor:
        """ID prefill at position 0 of every row (the reference's
        `prefill`): fills `caches` in place; -> (B, 1, vocab_padded)
        int32 logits at column `last_index` (an int, or None: the last
        column).  `batch` is (B, S) tokens or an embeds model's (B, S,
        d) int8 rows."""
        B, S = batch.shape[:2]
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

        batch (B, C) int32 tokens, or an embeds model's (B, C, d) int8
        rows (one chunk per slot row; decode rows are width-1 chunks);
        start_pos (B,) int32 position of each row's first token
        (INACTIVE_POS for parked rows); last_index
        (B,) int32 column whose logits to return.  Writes every row's
        K/V into `caches` in place.  -> (B, 1, vocab_padded) int32.

        The recurrent families: every row runs its chunk after its
        state, parked rows too (positions do not enter), and the state
        advances in place; the hybrid's shared applications write their
        own KV pools.  x0, the shared block's side input, is the
        embedding's int8 image."""
        x0 = x = self.embed_in_id(t, batch)
        blks = (self.block(0), self.block(1)) if self.pair else (
            self.block(),)
        kv = ({"table": caches["table"],
               "contiguous": bool(caches.get("contiguous", False))}
              if self.has_kv else None)
        for kind, i in self.steps():
            if kind == "shared":
                x = self.shared_block().apply_id(
                    t["shared"][i], x, x0,
                    {"k": caches["k"][i], "v": caches["v"][i], **kv},
                    start_pos)
            elif self.recurrent:
                x = blks[0].apply_id(t["layers"][i], x,
                                     {"conv": caches["conv"][i],
                                      "h": caches["h"][i]})
            else:
                x = blks[i % len(blks)].apply_id(
                    t["layers"][i], x,
                    {"k": caches["k"][i], "v": caches["v"][i], **kv},
                    start_pos)
        return self._last_logits(t, x, last_index)

    def _last_logits(self, t: dict, x: torch.Tensor,
                     last_index: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(x.shape[0], device=x.device)
        h = x[rows, last_index.to(torch.int64)][:, None, :]
        return self.logits_id(t, h)
