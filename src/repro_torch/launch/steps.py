"""Step builders, shardings and abstract inputs for the (arch x shape)
cells (port of `repro.launch.steps`).

Shape -> step:
  train_4k    -> train step    (FQ + AdamW)
  prefill_32k -> prefill step  (ID, fills the cache)
  decode_32k  -> decode step   (ID, one token over a 32k cache)
  long_500k   -> decode step   (ID, a 512k state; ssm and hybrid only)

`build_train_step(lm, microbatches=M, mesh=None)` is the reference's
FakeQuantized train step: the gradient of `lm.loss_fn` at Rep.FQ
(`loss_fn_embeds` for an embeds model, whose batch is {"embeds",
"targets"}; a token model's is {"tokens"}; every family, the MoE's loss
with its 0.01 aux term), accumulated in sequence over M slices of the
batch when M > 1, then `cosine_schedule` (total 10000, the reference's
default here) and `adamw_update`.  Eager torch; autograd replaces
`jax.value_and_grad`.  The reference re-pins each microbatch slice to
the batch axes with `hint(t, "batch0")`; the port's slices are plain
tensors of the rank's own rows, so there is nothing to re-pin.

With a `mesh` (a DeviceMesh with the production dims) the step is the
sharded one, explicit per-rank work where the reference lets GSPMD
partition its graph:

  * every leaf of trainable, qstate and both Adam moments is a DTensor
    holding the rank's shard of its placements (`train_shardings`,
    `sharding.place.distribute`);
  * each leaf is gathered in full for the forward and the backward
    (`sharding.place.gather`);
  * the batch splits over ("pod", "data") by `batch_spec` (a batch the
    mesh does not divide replicates, as `sanitize_spec` does, so no
    shard is ragged); an MoE model's rows of one microbatch must hold a
    whole number of `moe_group`-token groups, or routing and capacity
    would change, and the step raises;
  * the loss is the mean over the global batch (each rank's mean,
    summed over the batch ranks, over their number); the gradients are
    summed over the batch ranks and divided by their number; over
    "model" each rank keeps its slice and sums nothing (the model ranks
    saw the same rows);
  * the clip's norm is that of the whole gradients, which every rank
    holds, and AdamW then runs on the rank's shards alone.

On a mesh whose batch dims are 1 the step is the unsharded one bit for
bit.  `train_shardings` / `serve_shardings` give the placements
(`sharding.rules`), `train_input_specs` / `train_state_specs` /
`serve_input_specs` the cells' inputs as meta tensors
(`launch.specs`).  The reference's `lower_cell` (jit, lower, compile)
has no counterpart: its job, a cell's inputs and placements with
nothing allocated, is `launch.dryrun.plan_cell`'s.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import variants
from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding import place
from repro_torch.sharding.rules import (
    Sharding, batch_spec, caches_sharding, mesh_sizes, params_sharding,
    shard_index, sharding_of,
)

SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def cell_supported(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if runnable; otherwise the documented skip reason."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("skip: pure full-attention arch at 524k decode "
                "(assignment: sub-quadratic only)")
    return None


# configs of 100 B+ parameters keep the Adam moments in bfloat16
# (`adamw_init(..., dtype=torch.bfloat16)`)
MOMENTS_BF16 = {"llama4_maverick_400b_a17b", "nemotron_4_340b"}

# the reference's gradient-accumulation factors for its train_4k cells
MICROBATCH = {
    ("olmoe_1b_7b", "train_4k"): 4,
    ("llama4_maverick_400b_a17b", "train_4k"): 4,
    ("internvl2_76b", "train_4k"): 4,
    ("nemotron_4_340b", "train_4k"): 8,
    ("chatglm3_6b", "train_4k"): 2,
    ("llama3_2_3b", "train_4k"): 2,
    ("falcon_mamba_7b", "train_4k"): 8,
    ("zamba2_1_2b", "train_4k"): 4,
    ("musicgen_medium", "train_4k"): 2,
}


def value_and_grad(loss_of: Callable, trainable, *args):
    """-> (loss, grads): `loss_of(trainable, *args)` and its gradient
    with respect to every leaf of `trainable` (zeros where a leaf does
    not reach the loss), in the tree's structure."""
    req = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
    loss = loss_of(req, *args)
    grads = torch.autograd.grad(loss, tree_leaves(req), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(trainable, list(grads))


BATCH_DIMS = ("pod", "data")


def batch_width(mesh) -> int:
    """The number of batch shards of `mesh`: its "pod" x "data" size."""
    sizes = mesh_sizes(mesh)
    n = 1
    for d in BATCH_DIMS:
        n *= sizes.get(d, 1)
    return n


def local_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch leaf (`batch_spec`: the batch
    dim over ("pod", "data"), replicated where they do not divide it);
    a DTensor batch gives its local shard."""
    if place.is_placed(x):
        return place.local(x)
    spec = batch_spec(mesh, x.dim(), shape=tuple(x.shape))
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return x[shard_index(tuple(x.shape), spec, mesh, coords)]


def _check_moe_groups(lm, batch: dict, microbatches: int) -> None:
    c = lm.cfg
    if c.family != "moe":
        return
    x = batch["embeds"] if "embeds" in batch else batch["tokens"][:, :-1]
    B, S = x.shape[0], x.shape[1]
    T = B // microbatches * S
    if T % c.moe_group:
        raise ValueError(
            f"a rank's microbatch holds {T} tokens, not a whole number of "
            f"MoE groups of {c.moe_group}: the groups would straddle the "
            "batch shards and routing and capacity would change")


def _all_reduce_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `t` over the mesh's batch dims, in place."""
    for d in BATCH_DIMS:
        if d in mesh.mesh_dim_names and mesh.size(
                mesh.mesh_dim_names.index(d)) > 1:
            dist.all_reduce(t, group=mesh.get_group(d))
    return t


def build_train_step(lm, *, microbatches: int = 1, mesh=None) -> Callable:
    """FQ train step (trainable, opt_state, batch) -> (loss, new
    trainable, new opt_state).  ``microbatches`` > 1 accumulates the
    gradient over that many slices of the batch in sequence: activation
    memory scales down by the factor, the math stays the reference's
    (float32 sums, then one scale by 1 / microbatches).  With `mesh` the
    sharded step of the module docstring: trainable and opt_state are
    placed trees (DTensor leaves), the batch the global one (or placed)
    and the loss the global mean, the same on every rank."""
    c = lm.cfg

    def loss_of(tr, mb):
        if c.input_mode == "embeds":
            return lm.loss_fn_embeds(tr["params"], tr["qstate"],
                                     mb["embeds"], mb["targets"], Rep.FQ)
        return lm.loss_fn(tr["params"], tr["qstate"], mb["tokens"], Rep.FQ)

    def grads_of(trainable, batch):
        if microbatches == 1:
            return value_and_grad(loss_of, trainable, batch)
        mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                            *v.shape[1:]) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(trainable)[0].device)
        g_sum = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), trainable)
        for m in range(microbatches):
            li, gi = value_and_grad(loss_of, trainable,
                                    {k: v[m] for k, v in mbs.items()})
            g_sum = tree_map(torch.add, g_sum, gi)
            loss_sum = loss_sum + li
        inv = 1.0 / microbatches
        return loss_sum * inv, tree_map(lambda g: g * inv, g_sum)

    def train_step(trainable, opt_state, batch):
        loss, grads = grads_of(trainable, batch)
        lr = cosine_schedule(opt_state["step"])
        new_tr, new_opt = adamw_update(trainable, grads, opt_state, lr=lr)
        return loss, new_tr, new_opt

    if mesh is None:
        return train_step
    width = batch_width(mesh)

    def sharded_step(trainable, opt_state, batch):
        full = tree_map(place.gather, trainable)
        mb = {k: local_batch(v, mesh) for k, v in batch.items()}
        _check_moe_groups(lm, mb, microbatches)
        loss, grads = grads_of(full, mb)
        del full
        if width > 1:
            loss = _all_reduce_batch(loss.clone(), mesh) / width
            grads = tree_map(
                lambda g: _all_reduce_batch(g, mesh) / width, grads)
        gnorm = global_norm(grads)
        g_loc = tree_map(lambda g, p: place.shard_of(
            g, p.device_mesh, p.placements), grads, trainable)
        del grads
        opt_loc = tree_map(place.local, opt_state)
        lr = cosine_schedule(opt_loc["step"])
        new_tr, new_opt = adamw_update(tree_map(place.local, trainable),
                                       g_loc, opt_loc, lr=lr, gnorm=gnorm)
        return (loss, tree_map(place.rewrap, new_tr, trainable),
                tree_map(place.rewrap, new_opt, opt_state))

    return sharded_step


def train_input_specs(lm, shape: str) -> dict:
    """A train cell's global batch, on meta."""
    c = lm.cfg
    B, S = SHAPES[shape]["batch"], SHAPES[shape]["seq"]
    if c.input_mode == "embeds":
        return {"embeds": torch.empty((B, S, c.d_model), dtype=torch.bfloat16,
                                      device="meta"),
                "targets": torch.empty((B, S), dtype=torch.int32,
                                       device="meta")}
    return {"tokens": torch.empty((B, S + 1), dtype=torch.int32,
                                  device="meta")}


def train_state_specs(lm):
    """-> (trainable, opt state) on meta: float32 params and qstate,
    the Adam moments in bfloat16 for MOMENTS_BF16."""
    trainable = {"params": specs_mod.float_param_specs(lm),
                 "qstate": specs_mod.qstate_specs(lm)}
    mdt = (torch.bfloat16 if lm.cfg.name in MOMENTS_BF16 else torch.float32)
    return trainable, adamw_init(trainable, dtype=mdt)


def _replicated(mesh) -> Sharding:
    return sharding_of((), mesh)


def train_shardings(lm, mesh, shape: str):
    """-> ((trainable, opt, batch) shardings, (loss, trainable, opt)
    shardings, (trainable, opt, batch) meta specs).  Under the variant
    ``train_zero2`` the params replicate across "data" (ZeRO-2); the
    moments stay 2-D sharded."""
    trainable, opt = train_state_specs(lm)
    tr_sh = params_sharding(trainable, mesh,
                            weight_stationary=variants.get("train_zero2"))
    opt_sh = {"mu": params_sharding(opt["mu"], mesh),
              "nu": params_sharding(opt["nu"], mesh),
              "step": _replicated(mesh)}
    batch = train_input_specs(lm, shape)
    b_sh = {k: sharding_of(batch_spec(mesh, v.dim(), shape=tuple(v.shape)),
                           mesh) for k, v in batch.items()}
    out_sh = (_replicated(mesh), tr_sh, opt_sh)
    return (tr_sh, opt_sh, b_sh), out_sh, (trainable, opt, batch)


def build_prefill_step(lm) -> Callable:
    def prefill_step(tables, batch, caches):
        return lm.prefill(tables, batch, caches)
    return prefill_step


def build_decode_step(lm) -> Callable:
    def decode_step(tables, token, caches, pos):
        return lm.decode_step(tables, token, caches, pos)
    return decode_step


def serve_input_specs(lm, shape: str):
    """A serve cell's inputs on meta: (tables, batch, caches) for
    prefill, (tables, token, caches, pos) for decode; the caches the
    port's ID layout (`launch.specs.cache_specs`)."""
    c = lm.cfg
    s = SHAPES[shape]
    B, S = s["batch"], s["seq"]
    tables = specs_mod.deploy_specs(lm)
    caches = specs_mod.cache_specs(lm, B, S)
    n = S if s["kind"] == "prefill" else 1
    if c.input_mode == "embeds":
        x = torch.empty((B, n, c.d_model), dtype=torch.int8, device="meta")
    else:
        x = torch.empty((B, n), dtype=torch.int32, device="meta")
    if s["kind"] == "prefill":
        return tables, x, caches
    return tables, x, caches, torch.empty((), dtype=torch.int32,
                                          device="meta")


def serve_shardings(lm, mesh, shape: str):
    """-> (input shardings, (logits, caches) shardings, meta inputs);
    the tables under ``serve_weight_stationary`` replicate across
    "data"."""
    ins = serve_input_specs(lm, shape)
    t_sh = params_sharding(
        ins[0], mesh,
        weight_stationary=variants.get("serve_weight_stationary"))
    c_sh = caches_sharding(ins[2], mesh)
    x_sh = sharding_of(batch_spec(mesh, ins[1].dim(),
                                  shape=tuple(ins[1].shape)), mesh)
    B = ins[1].shape[0]
    logits_sh = sharding_of(batch_spec(mesh, 3, shape=(B, 1, lm.cfg.vocab)),
                            mesh)
    if SHAPES[shape]["kind"] == "prefill":
        return (t_sh, x_sh, c_sh), (logits_sh, c_sh), ins
    return (t_sh, x_sh, c_sh, _replicated(mesh)), (logits_sh, c_sh), ins
