"""Placing trees of tensors on a DeviceMesh by `sharding.rules`'s
`Sharding`s, and gathering them back.

DTensor is the container: every leaf of a placed tree is a `DTensor`
whose local tensor is this rank's shard alone (its own storage, so a
rank holds only its placements' bytes).  The work on the shards is
explicit: `gather` rebuilds the full tensor with one `all_gather` a
sharded mesh dim on that dim's process group, innermost mesh dim
first, so a tensor dim split over ("pod", "data") comes back
pod-major, the order `to_placements` gives it; `shard_of` cuts a full
tensor to this rank's shard with no communication.  Nothing here runs
a DTensor operator, so the port's custom autograd functions (PACT's
STE, the island ops, `float_matmul`) see plain tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import tree_leaves, tree_map


def is_placed(x) -> bool:
    return isinstance(x, DTensor)


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of `full` under `placements` (mesh dims in
    order, each `Shard(i)` splitting the rank's part of dim i), as a
    tensor of its own."""
    coord = mesh.get_coordinate()
    t = full
    for m, pl in enumerate(placements):
        if pl.is_shard() and mesh.size(m) > 1:
            w = t.shape[pl.dim] // mesh.size(m)
            t = t.narrow(pl.dim, coord[m] * w, w)
    return t.clone(memory_format=torch.contiguous_format)


def place(full: torch.Tensor, sharding):
    """A full tensor (the same on every rank) -> a DTensor of this
    rank's shard under `sharding` (mesh, placements, spec)."""
    local = shard_of(full, sharding.mesh, sharding.placements)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                                 run_check=False, shape=full.shape,
                                 stride=_contiguous_stride(full.shape))


def _contiguous_stride(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def distribute(tree, shardings):
    """`place` over a tree and its matching tree of `Sharding`s."""
    return tree_map(place, tree, shardings)


def local(x):
    """A DTensor's local shard; any other leaf as it is."""
    return x.to_local() if is_placed(x) else x


def gather(x) -> torch.Tensor:
    """The full tensor of a DTensor (collective: every rank of the mesh
    calls it); any other leaf as it is."""
    if not is_placed(x):
        return x
    mesh, t = x.device_mesh, x.to_local()
    for m in reversed(range(mesh.ndim)):
        pl = x.placements[m]
        n = mesh.size(m)
        if pl.is_shard() and n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(m))
            t = torch.cat(parts, dim=pl.dim)
    return t


def rewrap(new_local: torch.Tensor, like):
    """A new local shard in the placement of the DTensor `like`."""
    return DTensor.from_local(new_local, like.device_mesh, like.placements,
                                 run_check=False, shape=like.shape,
                                 stride=like.stride())


def local_bytes(tree) -> int:
    """The bytes of this rank's local shards of a placed tree."""
    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves(tree))
