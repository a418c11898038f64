"""Shape-and-dtype stand-ins for the dry run (port of
`repro.launch.specs`): trees of tensors on the "meta" device, which
carry a shape and a dtype and allocate nothing.

  deploy_specs(lm)               what `DecoderLM.deploy` returns (the
                                 reference's table layout, layer-stacked
                                 segments), "meta" stripped, without
                                 the host's numpy deploy math
  float_param_specs(lm, dtype)   `init_np`'s float tree, from one
                                 layer's shapes (`layers.common.
                                 shapes_only`: no weight is drawn)
  qstate_specs(lm)               `init_qstate` on meta
  cache_specs(lm, B, T, rep)     `init_caches` on meta: the port's ID
                                 layout (pools with the trash page and
                                 the slot table) or, at FP / FQ, the
                                 reference's bf16 float layout

Materializing 340 B int8 weights is impossible on a host; the tests
hold every tree against the real deploy, init and caches at reduced
size (paths, shapes, dtypes) and against the reference's specs.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_map
from repro_torch.layers.common import ActKind, shapes_only
from repro_torch.models.lm import ACT_MAP, DecoderLM

I8 = torch.int8
I32 = torch.int32
F32 = torch.float32
META = "meta"


def _s(shape, dt) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dt, device=META)


def _rqt(n=None) -> dict:
    def per():
        return _s((n,), I32) if n else _s((), I32)
    return {"m": per(), "d": _s((), I32), "s0": per(), "lo": per(),
            "hi": per(), "zp": _s((), I32)}


def _rqt2d(E, n) -> dict:
    return {"m": _s((E, n), I32), "d": _s((), I32), "s0": _s((E, n), I32),
            "lo": _s((E, n), I32), "hi": _s((E, n), I32), "zp": _s((), I32)}


def _lin(d_in, d_out) -> dict:
    return {"w_q": _s((d_in, d_out), I8), "b_q": _s((d_out,), I32)}


def _act(kind: ActKind, n) -> dict:
    if kind in (ActKind.IDENTITY, ActKind.RELU):
        return {"rqt": _rqt(n)}
    if kind is ActKind.RELU2:
        return {"rqt": _rqt(n), "rqt2": _rqt()}
    return {"rqt": _rqt(n), "lut": _s((256,), I8)}


def _attn(c: ArchConfig, d_in=None) -> dict:
    d = d_in or c.d_model
    H, K, hd = c.n_heads, c.n_kv_heads, c.hd
    # the per-kv-head int4 pack / unpack images; a one-head site's
    # tables are scalars
    return {
        "wq": _lin(d, H * hd), "wk": _lin(d, K * hd), "wv": _lin(d, K * hd),
        "q_rqt": _rqt(H * hd), "k_rqt": _rqt(K * hd), "v_rqt": _rqt(K * hd),
        "score_scale": _s((), F32),
        "sm_tabs": {"m_ln2": _s((), I32), "d_ln2": _s((), I32),
                    "ln2_img": _s((), I32), "r_step": _s((), I32),
                    "exp_lut": _s((256,), I32)},
        "ctx_rqt": _rqt(),
        "kv4": {n: _rqt(K if K > 1 else None)
                for n in ("k_pack", "k_unpack", "v_pack", "v_unpack")},
        "wo": _lin(H * hd, c.d_model),
    }


def _norm(d, bias) -> dict:
    t = {"g_q": _s((d,), I8), "m": _s((), I32), "sh": _s((), I32)}
    if bias:
        t["b_q"] = _s((d,), I32)
    return t


def _add(b_vec=None, a_vec=None) -> dict:
    return {"rq_a": _rqt(a_vec), "rq_b": _rqt(b_vec),
            "zp_a": _s((), I32), "zp_b": _s((), I32)}


def _mlp(c: ArchConfig) -> dict:
    d, f = c.d_model, c.d_ff
    kind = ACT_MAP[c.act]
    if c.gated:
        return {"wg": _lin(d, f), "g_tab": _act(kind, f),
                "wu": _lin(d, f), "u_rqt": _rqt(f), "h_rqt": _rqt(),
                "wd": _lin(f, d), "zp_g": _s((), I32)}
    return {"wu": _lin(d, f), "u_tab": _act(kind, f), "wd": _lin(f, d)}


def _moe(c: ArchConfig) -> dict:
    d, f, E = c.d_model, c.d_ff, c.n_experts
    return {
        "router": _lin(d, E), "router_scale": _s((E,), F32),
        "wg_q": _s((E, d, f), I8), "wu_q": _s((E, d, f), I8),
        "wd_q": _s((E, f, d), I8),
        "g_rqt": _rqt2d(E, f), "g_lut": _s((256,), I8),
        "u_rqt": _rqt2d(E, f), "h_rqt": _rqt(), "o_rqt": _rqt2d(E, d),
        "zp_g": _s((), I32),
    }


def _mamba1(c: ArchConfig) -> dict:
    d = c.d_model
    di, ds = c.ssm_expand * d, c.ssm_state
    r = max(1, -(-d // 16))
    K = 4
    return {
        "in_proj": _lin(d, 2 * di), "xz_rqt": _rqt(2 * di),
        "conv_wq": _s((K, di), I8), "conv_bq": _s((di,), I32),
        "conv_rqt": _rqt(), "conv_lut": _s((256,), I8),
        "zp_conv": _s((), I32),
        "x_proj": _lin(di, r + 2 * ds), "xdb_rqt": _rqt(r + 2 * ds),
        "dt_proj": _lin(r, di), "dt_scale": _s((di,), F32),
        "A": _s((di, ds), F32), "Dv": _s((di,), F32),
        "eps_conv_f": _s((), F32), "zp_conv_f": _s((), F32),
        "eps_xdb_f": _s((), F32), "eps_y_inv": _s((), F32),
        "z_lut": _s((256,), I8), "zp_z": _s((), I32),
        "gated_rqt": _rqt(), "out_proj": _lin(di, d),
    }


def _mamba2(c: ArchConfig) -> dict:
    d = c.d_model
    di, ds = c.ssm_expand * d, c.ssm_state
    H = di // c.ssm_head_dim
    G = 1
    d_in_proj = 2 * di + 2 * G * ds + H
    d_conv_in = di + 2 * G * ds
    K = 4
    return {
        "in_proj": _lin(d, d_in_proj), "p_rqt": _rqt(d_in_proj),
        "conv_wq": _s((K, d_conv_in), I8), "conv_bq": _s((d_conv_in,), I32),
        "conv_rqt": _rqt(), "conv_lut": _s((256,), I8),
        "A": _s((H,), F32), "Dv": _s((H,), F32), "dt_bias": _s((H,), F32),
        "eps_p_f": _s((), F32), "eps_conv_f": _s((), F32),
        "zp_conv_f": _s((), F32), "norm_g_f": _s((di,), F32),
        "eps_n_inv": _s((), F32), "out_proj": _lin(di, d),
    }


def _dense_block(c: ArchConfig, moe: bool) -> dict:
    t = {
        "norm1": _norm(c.d_model, c.norm_bias),
        "attn": _attn(c),
        "add1": _add(b_vec=c.d_model),
        "norm2": _norm(c.d_model, c.norm_bias),
        "add2": _add(b_vec=None if moe else c.d_model),
    }
    if moe:
        t["moe"] = _moe(c)
        if c.shared_expert:
            t["mlp"] = _mlp(c)
            t["sh_rqt"] = _rqt(c.d_model)
    else:
        t["mlp"] = _mlp(c)
    return t


def _mamba_block(c: ArchConfig) -> dict:
    core = _mamba1(c) if c.ssm_kind == "mamba1" else _mamba2(c)
    return {"norm": _norm(c.d_model, False), "core": core,
            "add": _add(b_vec=c.d_model)}


def _shared_block(c: ArchConfig) -> dict:
    return {
        "cat_rqt_x": _rqt(), "cat_rqt_x0": _rqt(),
        "norm": _norm(2 * c.d_model, False),
        "attn": _attn(c, d_in=2 * c.d_model),
        "add": _add(b_vec=c.d_model),
    }


def stack_spec(tree, n: int):
    """A tree of meta tensors with a leading dim of n on every leaf."""
    return tree_map(lambda s: _s((n,) + tuple(s.shape), s.dtype), tree)


def deploy_specs(lm: DecoderLM) -> Dict[str, Any]:
    """Meta mirror of `lm.deploy(...)`, "meta" stripped."""
    c = lm.cfg
    t: Dict[str, Any] = {}
    if c.input_mode == "tokens":
        t["embed"] = {"table_q": _s((c.vocab_padded, c.d_model), I8)}
    segs = []
    for kind, _, n in lm.plan():
        if kind == "dense":
            one = _dense_block(c, moe=c.n_experts > 0)
        elif kind == "pair":
            one = {"a": _dense_block(c, False), "b": _dense_block(c, True)}
        elif kind == "mamba":
            one = _mamba_block(c)
        else:  # hybrid
            one = {"m": stack_spec(_mamba_block(c), c.shared_attn_every),
                   "sh": _shared_block(c)}
        segs.append(stack_spec(one, n))
    t["segments"] = segs
    t["norm_f"] = _norm(c.d_model, c.norm_bias)
    t["head"] = _lin(c.d_model, c.vocab_padded)
    return t


def _meta_of(tree, dtype):
    return tree_map(lambda a: _s(np.shape(a), dtype), tree)


def float_param_specs(lm: DecoderLM, dtype=torch.float32) -> Dict[str, Any]:
    """Meta mirror of `lm.init_np(seed)` cast to `dtype`: one block's
    tree (every block of the config has its shapes, but a pair's two)
    stacked as `init_np` stacks the layers."""
    c = lm.cfg
    with shapes_only():
        one = _meta_of(lm.init_layer_np(0, 0), dtype)
        if lm.pair:
            one = {"a": one, "b": _meta_of(lm.init_layer_np(0, 1), dtype)}
        p: Dict[str, Any] = {}
        if c.input_mode == "tokens":
            p["embed"] = _meta_of(lm.init_embed_np(0), dtype)
        segs = []
        for kind, _, n in lm.plan():
            if kind == "hybrid":
                segs.append({"m": stack_spec(
                    stack_spec(one, c.shared_attn_every), n)})
            else:
                segs.append(stack_spec(one, n))
        p["segments"] = segs
        norm_f, head = lm.init_head_np(0)
        p["norm_f"], p["head"] = _meta_of(norm_f, dtype), _meta_of(head, dtype)
        if lm.groups:
            p["shared_attn"] = _meta_of(lm.init_shared_np(0), dtype)
    return p


def qstate_specs(lm: DecoderLM) -> Dict[str, Any]:
    """Meta mirror of `lm.init_qstate()`."""
    return lm.init_qstate(device=META)


def cache_specs(lm: DecoderLM, B: int, max_len: int, rep: Rep = Rep.ID):
    """Meta mirror of `lm.init_caches(B, max_len, rep)`."""
    return lm.init_caches(B, max_len, rep, device=META)
