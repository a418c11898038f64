"""Step builders for the (arch x shape) cells (port of
`repro.launch.steps`: the shapes, the cell filter, the train step and
its gradient-accumulation factors; the sharding and lowering functions
are multi-device work, ROADMAP item 12).

`build_train_step(lm, microbatches=M)` is the reference's FakeQuantized
train step: the gradient of `lm.loss_fn` at Rep.FQ (`loss_fn_embeds`
for an embeds model, whose batch is {"embeds", "targets"}; a token
model's is {"tokens"}; every family, the MoE's loss with its 0.01 aux
term), accumulated in sequence over M slices of the
batch when M > 1, then `cosine_schedule` (total 10000, the reference's
default here) and `adamw_update`.  Eager torch; autograd replaces
`jax.value_and_grad`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import cosine_schedule

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


def build_train_step(lm, *, microbatches: int = 1) -> Callable:
    """FQ train step (trainable, opt_state, batch) -> (loss, new
    trainable, new opt_state).  ``microbatches`` > 1 accumulates the
    gradient over that many slices of the batch in sequence: activation
    memory scales down by the factor, the math stays the reference's
    (float32 sums, then one scale by 1 / microbatches)."""
    c = lm.cfg

    def loss_of(tr, mb):
        if c.input_mode == "embeds":
            return lm.loss_fn_embeds(tr["params"], tr["qstate"],
                                     mb["embeds"], mb["targets"], Rep.FQ)
        return lm.loss_fn(tr["params"], tr["qstate"], mb["tokens"], Rep.FQ)

    def train_step(trainable, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_of, trainable, batch)
        else:
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
            loss = loss_sum * inv
            grads = tree_map(lambda g: g * inv, g_sum)
        lr = cosine_schedule(opt_state["step"])
        new_tr, new_opt = adamw_update(trainable, grads, opt_state, lr=lr)
        return loss, new_tr, new_opt

    return train_step
