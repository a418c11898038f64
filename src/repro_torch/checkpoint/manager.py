"""Checkpoint manager: atomic, keep-N (port of
`repro.checkpoint.manager`, in its on-disk layout).

Layout per step:
    <dir>/step_00000123.tmp/   -> written fully, then renamed to
    <dir>/step_00000123/
        meta.json            (step, tree structure, shapes and dtypes)
        arr_000000.npy ...   (one file per leaf, on the host)

Leaves are numbered in jax's flatten order (dict keys sorted, lists in
order: `core.tree.tree_leaves`), so a checkpoint the reference writes
restores into the port's tree of the same structure and the reverse.
A bfloat16 leaf is stored as the reference's numpy stores it: its two
bytes, dtype "bfloat16" in meta.json.

Sharded trees (DTensor leaves, `sharding.place`): `save` gathers each
leaf in full on every rank (a collective: every rank of the mesh calls
it) and rank 0 alone writes, then all ranks wait for the publish, so
the files are exactly an unsharded checkpoint's.  `restore(...,
shardings=)` loads each leaf in full and places this rank's shard by
the matching `Sharding` of the CURRENT mesh, which may differ from the
one the checkpoint was saved on: the elastic re-shard (a (1, 2)
checkpoint restores onto (2, 1), onto one rank, or unsharded).
Without shardings each leaf goes to the device of `like`'s leaf.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_unflatten, treedef_str
from repro_torch.sharding import place


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Write `tree` as step `step` (atomically: a .tmp directory renamed
    when complete) and keep the newest `keep` steps.  A placed tree is
    gathered on every rank and written by rank 0."""
    leaves = tree_leaves(tree)
    if any(place.is_placed(x) for x in leaves):
        full = [place.gather(x) for x in leaves]
        path = Path(ckpt_dir) / f"step_{step:08d}"
        if dist.get_rank() == 0:
            save(ckpt_dir, step, tree_unflatten(tree, full), keep=keep)
        dist.barrier()  # every rank returns after the publish
        return path
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    meta = {"step": step, "treedef": treedef_str(tree),
            "n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        np.save(tmp / f"arr_{i:06d}.npy", arr)
        dtype = ("bfloat16" if isinstance(leaf, torch.Tensor)
                 and leaf.dtype == torch.bfloat16 else str(arr.dtype))
        meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    _gc(base, keep)
    return final


def _gc(base: Path, keep: int):
    steps = sorted(
        p for p in base.glob("step_[0-9]*")
        if p.is_dir() and not p.name.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(old)


def latest_step(ckpt_dir) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(base.glob("step_[0-9]*"))
    steps = [p for p in steps if p.is_dir() and (p / "meta.json").exists()]
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" or (arr.dtype.kind == "V" and arr.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, step: int, like: Any, *, shardings: Any = None) -> Any:
    """Restore into the structure of `like`: the leaf count and every
    shape must match (as the reference asserts); each leaf keeps the
    file's dtype and goes to the device of `like`'s leaf, or with
    `shardings` (a matching tree of `sharding.rules.Sharding`) this
    rank's shard of it is placed on the current mesh (on the device of
    `like`'s leaf: its local shard's for a DTensor)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((path / "meta.json").read_text())
    leaves_like = tree_leaves(like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint {path} holds {meta['n_leaves']} "
                         f"leaves, the tree {len(leaves_like)}")
    sh = (tree_leaves(shardings) if shardings is not None
          else [None] * len(leaves_like))
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(path / f"arr_{i:06d}.npy")
        expect = tuple(np.shape(ref))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {i}: shape {arr.shape} in the "
                             f"checkpoint, {expect} in the tree")
        t = _from_numpy(arr, meta["leaves"][i]["dtype"])
        ref_t = place.local(ref)
        device = ref_t.device if isinstance(ref_t, torch.Tensor) else "cpu"
        t = t.to(device)
        out.append(t if sh[i] is None else place.place(t, sh[i]))
    return tree_unflatten(like, out)
