"""Production-mesh dry run of the port (port of `repro.launch.dryrun`'s
record), on a fake process group: nothing is allocated on any device.

For one (arch x shape x mesh) cell: the cell's inputs as meta tensors
(`launch.steps`: train state and batch, or tables, tokens and caches)
and their placements on the (16, 16) pod or (2, 16, 16) multipod
`DeviceMesh` (`launch.mesh.make_production_mesh`, `sharding.rules`),
then the reference's JSON record:

  memory.argument_bytes_per_dev / output_bytes_per_dev
                  each input / output leaf's local shard bytes on one
                  rank (`sharding.rules.local_shape`; every sharded dim
                  divides, `sanitize_spec`)
  collectives     the bytes (each op's result) and counts a rank issues
                  in one step of the port's explicit sharded work: a
                  train cell's all-gather of every sharded leaf of the
                  trainable (once a step, whatever the microbatches),
                  its gradient all-reduce over the batch dims ("pod",
                  "data": full float32 gradients) and the loss's; a
                  serve cell's all-gather of every sharded table and
                  cache leaf
  roofline        the reference's analytic model FLOPs (6 N D train,
                  2 N D serve, N the active params, D the tokens of
                  the step) over the mesh's cards at the H100's peak
                  (bfloat16 train, int8 serve); the memory term the
                  argument and output bytes of a rank over its HBM
                  rate; the collective term the ring wire bytes (2x
                  all-reduce + all-gather) over NVLink 4

Where the reference reads XLA's compiler (`lower_s`, `compile_s`,
`memory.temp_bytes_per_dev`, `memory.code_bytes`, `cost.flops`,
`cost.bytes_accessed`, `roofline.hlo_flops`, `roofline.useful_ratio`)
eager torch has no counterpart: those fields are null, each with its
reason in `null_reasons`.

Run (a fake process group of 256 or 512 ranks in this one process,
torn down at the end; nothing touches a GPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
      --shape train_4k --mesh pod --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import LM_ARCH_IDS, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import variants
from repro_torch.launch.steps import (
    BATCH_DIMS, MICROBATCH, SHAPES, cell_supported, serve_shardings,
    train_shardings,
)
from repro_torch.models.lm import DecoderLM
from repro_torch.sharding.rules import local_shape, mesh_sizes

# NVIDIA H100 SXM5 80 GB (the card `chip_smoke.py` runs on), per card:
PEAK_BF16 = 989.4e12     # H100 SXM dense bfloat16 tensor-core FLOP/s
PEAK_INT8 = 1979e12      # H100 SXM dense int8 tensor-core OP/s
HBM_BW = 3.35e12         # H100 SXM HBM3 bytes/s
NVLINK_BW = 450e9        # H100 NVLink 4: 900 GB/s both ways, 450 a direction

RECORD_VERSION = 1

NULL_REASONS = {
    "lower_s": "XLA's lowering time; eager torch lowers nothing",
    "compile_s": "XLA's compile time; eager torch compiles nothing",
    "temp_bytes_per_dev": "XLA's buffer assignment; eager torch has no "
                          "compiled program to analyse",
    "code_bytes": "XLA's generated code size; eager torch generates none",
    "cost.flops": "XLA's cost analysis of the compiled program; the "
                  "analytic model FLOPs stand in (roofline.model_flops)",
    "cost.bytes_accessed": "XLA's cost analysis of the compiled program; "
                           "the memory term reads argument + output bytes",
    "hlo_flops": "no HLO: eager torch",
    "useful_ratio": "model FLOPs over HLO FLOPs; no HLO",
}

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def _nbytes(leaf, sharding=None, mesh=None) -> int:
    """A leaf's bytes, its local shard's under `sharding`; a leaf that
    is no tensor (the contiguous cache's flag) counts 0."""
    if not isinstance(leaf, torch.Tensor):
        return 0
    shape = tuple(leaf.shape)
    if sharding is not None:
        shape = local_shape(shape, sharding.spec, mesh)
    return int(np.prod(shape, dtype=np.int64)) * leaf.element_size()


def _sum_bytes(tree, shardings, mesh) -> int:
    return sum(_nbytes(x, s, mesh) for x, s in zip(tree_leaves(tree),
                                                    tree_leaves(shardings)))


def _gathers(tree, shardings, mesh, coll: dict) -> None:
    """The all-gathers that rebuild every sharded leaf: one a mesh dim
    it is split on (of size > 1), innermost first, each op's result the
    leaf gathered so far (`sharding.place.gather`)."""
    sizes = mesh_sizes(mesh)
    dims = list(sizes)
    for x, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        if not isinstance(x, torch.Tensor):
            continue
        cur = _nbytes(x, s, mesh)
        for d in reversed(dims):
            on = any(ax == d or (isinstance(ax, tuple) and d in ax)
                     for ax in s.spec)
            if on and sizes[d] > 1:
                cur *= sizes[d]
                coll["bytes"]["all-gather"] += cur
                coll["counts"]["all-gather"] += 1


def _reduces(tree, mesh, coll: dict) -> None:
    """The gradient all-reduce over the batch dims: the full float32
    gradient of every trainable leaf, one op a batch dim of size > 1,
    and the loss's."""
    sizes = mesh_sizes(mesh)
    n_dims = sum(1 for d in BATCH_DIMS if sizes.get(d, 1) > 1)
    if not n_dims:
        return
    for x in tree_leaves(tree) + [torch.empty((), device="meta")]:
        coll["bytes"]["all-reduce"] += x.numel() * 4 * n_dims
        coll["counts"]["all-reduce"] += n_dims


def plan_cell(arch: str, shape: str, mesh) -> dict:
    """One cell's inputs (meta tensors), their shardings and the output
    leaves, with nothing allocated: the job of the reference's
    `lower_cell` up to its lowering."""
    cfg = get_config(arch)
    reason = cell_supported(cfg, shape)
    if reason:
        raise ValueError(reason)
    s = SHAPES[shape]
    lm = DecoderLM(cfg, max_seq=s["seq"] + (1 if s["kind"] == "train"
                                             else 0))
    if s["kind"] == "train":
        in_sh, out_sh, ins = train_shardings(lm, mesh, shape)
        loss = torch.empty((), dtype=torch.float32, device="meta")
        outs = (loss, ins[0], ins[1])
    else:
        in_sh, out_sh, ins = serve_shardings(lm, mesh, shape)
        B = ins[1].shape[0]
        logits = torch.empty((B, 1, cfg.vocab_padded), dtype=torch.int32,
                             device="meta")
        outs = (logits, ins[2])
    mb = (variants.get("microbatches") or MICROBATCH.get((arch, shape), 1)
          if s["kind"] == "train" else 1)
    return {"lm": lm, "kind": s["kind"], "inputs": list(ins),
            "in_shardings": list(in_sh), "outputs": list(outs),
            "out_shardings": list(out_sh), "microbatches": mb}


def collectives(plan: dict, mesh) -> dict:
    """The collectives one rank issues in one step of the cell's
    explicit sharded work (see the module docstring)."""
    coll = {"bytes": dict.fromkeys(_KINDS, 0),
            "counts": dict.fromkeys(_KINDS, 0)}
    ins, shs = plan["inputs"], plan["in_shardings"]
    if plan["kind"] == "train":
        _gathers(ins[0], shs[0], mesh, coll)
        _reduces(ins[0], mesh, coll)
    else:
        _gathers(ins[0], shs[0], mesh, coll)
        _gathers(ins[2], shs[2], mesh, coll)
    return coll


def roofline(arch: str, shape: str, *, n_chips: int, hbm_bytes: float,
             coll: dict) -> dict:
    cfg = get_config(arch)
    s = SHAPES[shape]
    train = s["kind"] == "train"
    peak = PEAK_BF16 if train else PEAK_INT8
    tokens = s["batch"] * (s["seq"] if s["kind"] != "decode" else 1)
    model_flops = (6 if train else 2) * cfg.active_param_count() * tokens
    t_compute = model_flops / n_chips / peak
    t_memory = hbm_bytes / HBM_BW
    b = coll["bytes"]
    wire = (2.0 * b["all-reduce"] + b["all-gather"] + b["reduce-scatter"]
            + b["all-to-all"] + b["collective-permute"])
    t_coll = wire / NVLINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops": model_flops, "hlo_flops": None,
            "useful_ratio": None, "wire_bytes_per_dev_total": wire}


def run_cell(arch: str, shape: str, mesh_kind: str, mesh,
             variant: Optional[dict] = None) -> dict:
    """The reference's record of one cell on `mesh` (a production
    DeviceMesh of `mesh_kind`)."""
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "variant": variant or {}, "time": time.strftime("%F %T")}
    reason = cell_supported(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    with variants.use_variants(**(variant or {})):
        plan = plan_cell(arch, shape, mesh)
        coll = collectives(plan, mesh)
    arg = sum(_sum_bytes(x, s, mesh) for x, s in
              zip(plan["inputs"], plan["in_shardings"]))
    out = sum(_sum_bytes(x, s, mesh) for x, s in
              zip(plan["outputs"], plan["out_shardings"]))
    n_chips = int(np.prod(list(mesh_sizes(mesh).values())))
    rec.update({
        "status": "ok",
        "version": RECORD_VERSION,
        "n_chips": n_chips,
        "microbatches": plan["microbatches"],
        "lower_s": None,
        "compile_s": None,
        "memory": {"argument_bytes_per_dev": arg,
                   "output_bytes_per_dev": out,
                   "temp_bytes_per_dev": None, "code_bytes": None},
        "cost": {"flops": None, "bytes_accessed": None},
        "collectives": coll,
        "roofline": roofline(arch, shape, n_chips=n_chips,
                             hbm_bytes=float(arg + out), coll=coll),
        "null_reasons": NULL_REASONS,
    })
    return rec


def _fake_world(n: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=LM_ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="", help="k=v,k=v overrides")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    args = ap.parse_args(argv)
    variant = variants.parse(args.variant)
    if args.all:
        cells = [(a, sh) for a in LM_ARCH_IDS for sh in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    multi = args.mesh == "multipod"
    _fake_world(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi)
        n_err = 0
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{args.mesh}" + (
                f"__{args.tag}" if args.tag else "")
            print(f"[run] {tag}", flush=True)
            try:
                rec = run_cell(arch, shape, args.mesh, mesh, variant)
            except Exception as e:  # recorded: they are faults to fix
                n_err += 1
                rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
            dom = (f" dominant={rec['roofline']['dominant']}"
                   if rec.get("roofline") else "")
            print(f"  -> {rec['status']}{dom}", flush=True)
    finally:
        dist.destroy_process_group()
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
