"""Training entry point (port of `repro.launch.train`): QAT
(FakeQuantized) training of the dense, MoE, ssm and hybrid families
with the reference's substrate: synthetic data, AdamW, checkpoint /
restart, the straggler watch and optional int8 gradient compression.
A MoE model's batch of B x S tokens must divide into its `moe_group`
(64 reduced, 512 at full width): `QMoE._group` raises otherwise, as the
reference asserts.

`build` returns (lm, trainable, opt, train_step, stream) as the
reference's does: the params from `DecoderLM.init_np(seed)` and the
PACT clips from `init_qstate` (the reference's tree layout, so its
checkpoints restore here and the reverse), float32 AdamW moments (an
error-feedback state with --grad-compress), and an eager step: the
gradient of `loss_fn` at Rep.FQ through autograd, then (optionally)
`compress_decompress_grads`, `cosine_schedule(step, total=2000)` and
`adamw_update`.  The step runs on `device` (the card unless the caller
asks for the CPU).  Like the reference's `build`, it feeds token ids;
an embeds model (internvl2_76b) trains through
`launch.steps.build_train_step` on {"embeds", "targets"} batches.

CPU example (reduced config; `--arch olmoe_1b_7b`, `falcon_mamba_7b` or
`zamba2_1_2b` train the same way):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --reduced --device cpu --steps 30 --batch 8 --seq 64 --ckpt /tmp/ck
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.rep import Rep
from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
from repro_torch.launch.elastic import TrainSupervisor
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.lm import DecoderLM, params_to_torch
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    compress_decompress_grads, init_error_feedback)
from repro_torch.optim.schedule import cosine_schedule


def build(arch: str, *, reduced: bool, seq: int, batch: int,
          grad_compress: bool = False, microbatches: int = 1,
          device="cuda", seed: int = 0, n_layers: Optional[int] = None):
    """-> (lm, trainable, opt, train_step, stream).  `n_layers` cuts
    the depth (the config's first n layers at its full width).
    `microbatches` is accepted and unused, as in the reference's
    `build` (`launch.steps.build_train_step` accumulates)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} takes embeddings: train it through "
            "launch.steps.build_train_step on {'embeds', 'targets'} "
            "batches (this trainer's stream feeds token ids)")
    lm = DecoderLM(cfg, max_seq=seq + 1)
    trainable = {"params": params_to_torch(lm.init_np(seed), device),
                 "qstate": lm.init_qstate(device)}
    opt = adamw_init(trainable)
    if grad_compress:
        opt["err_fb"] = init_error_feedback(trainable)

    def loss_of(t, tokens):
        return lm.loss_fn(t["params"], t["qstate"], tokens, Rep.FQ)

    def train_step(tr, opt_state, tokens):
        loss, grads = value_and_grad(loss_of, tr, tokens)
        if grad_compress:
            # NEMO's quantizer on gradients (int8 images + error
            # feedback) before the data-parallel mean
            grads, new_err = compress_decompress_grads(
                grads, opt_state["err_fb"])
        lr = cosine_schedule(opt_state["step"], total=2000)
        new_tr, new_opt = adamw_update(tr, grads, opt_state, lr=lr)
        if grad_compress:
            new_opt["err_fb"] = new_err
        return loss, new_tr, new_opt

    stream = SyntheticStream(SyntheticConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    return lm, trainable, opt, train_step, stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the torch device to train on (default: the card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the float params' draw (DecoderLM.init_np)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to train on the CPU")

    lm, trainable, opt, step_fn, stream = build(
        args.arch, reduced=args.reduced, seq=args.seq, batch=args.batch,
        grad_compress=args.grad_compress, device=args.device,
        seed=args.seed)

    sup = TrainSupervisor(
        train_step=step_fn,
        make_batch=lambda s: torch.from_numpy(stream.batch(s)).to(
            args.device),
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every)
    out = sup.run(trainable, opt, n_steps=args.steps)
    ls = out["losses"]
    print(f"status={out['status']} step={out['step']} "
          f"loss {ls[0]:.4f} -> {ls[-1]:.4f}" if ls else out)
    return out


if __name__ == "__main__":
    main()
