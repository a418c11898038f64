"""AdamW with global-norm clipping (port of `repro.optim.adamw`), pure
functions over dicts and lists of tensors.

The moments mirror the param tree; `dtype` keeps them in bfloat16 for
the largest configs (`launch.steps.MOMENTS_BF16`).  The order of
operations is the reference's, and each constant enters in the dtype
the reference's weak typing gives it (the operand's: bf16(0.9) times a
bfloat16 moment, not float32(0.9)), so on the same gradients the
update is the reference's op for op; its `pow` and `sqrt` may differ
from XLA's by an ulp.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A python constant in `like`'s dtype, as jnp's weak typing
    converts it."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def adamw_init(params, *, dtype=torch.float32) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """The float32 L2 norm of every gradient leaf, summed leaf by leaf
    in the reference's (jax's) leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def adamw_update(params, grads, state: dict, *, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0,
                 gnorm: Optional[torch.Tensor] = None):
    """-> (new params, new state); every trainable leaf decays.
    `gnorm` is the clip's gradient norm where the caller has it (a
    sharded step updates its shards with the norm of the whole
    gradients); by default `global_norm(grads)`."""
    f32 = torch.float32
    step = state["step"] + 1
    if clip_norm is not None:
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.minimum(
            _c(1.0, gnorm),
            _c(clip_norm, gnorm) / torch.maximum(gnorm, _c(1e-9, gnorm)))
        grads = tree_map(lambda g: g * scale, grads)

    def mom1(m, g):
        return _c(b1, m) * m + _c(1 - b1, m) * g.to(m.dtype)

    def mom2(v, g):
        return _c(b2, v) * v + _c(1 - b2, v) * torch.square(g.to(v.dtype))

    mu = tree_map(mom1, state["mu"], grads)
    nu = tree_map(mom2, state["nu"], grads)
    s = step.to(f32)
    bc1 = _c(1.0, s) - torch.pow(_c(b1, s), s)
    bc2 = _c(1.0, s) - torch.pow(_c(b2, s), s)

    def upd(p, m, v):
        mhat = m.to(f32) / bc1
        vhat = v.to(f32) / bc2
        delta = mhat / (torch.sqrt(vhat) + _c(eps, vhat)) + _c(
            weight_decay, vhat) * p.to(f32)
        return (p.to(f32) - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "step": step}
