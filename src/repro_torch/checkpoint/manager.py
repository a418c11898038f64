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
bytes, dtype "bfloat16" in meta.json.  `restore` puts each leaf on the
device of the matching leaf of `like` (the reference places it with a
sharding; the port has one device).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten, treedef_str


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir, step: int, tree: Any, *, keep: int = 3) -> Path:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = tree_leaves(tree)
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


def restore(ckpt_dir, step: int, like: Any) -> Any:
    """Restore into the structure of `like`: the leaf count and every
    shape must match (as the reference asserts); each leaf keeps the
    file's dtype and goes to the device of `like`'s leaf."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((path / "meta.json").read_text())
    leaves_like = tree_leaves(like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint {path} holds {meta['n_leaves']} "
                         f"leaves, the tree {len(leaves_like)}")
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(path / f"arr_{i:06d}.npy")
        expect = tuple(np.shape(ref))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {i}: shape {arr.shape} in the "
                             f"checkpoint, {expect} in the tree")
        t = _from_numpy(arr, meta["leaves"][i]["dtype"])
        device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        out.append(t.to(device))
    return tree_unflatten(like, out)
