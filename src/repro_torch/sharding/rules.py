"""Sharding rules of the serving arena (port of the arena half of
`repro.sharding.rules`: `sanitize_spec`, `cache_spec`, `kv_head_axis`,
`arena_leaf_spec`, `arena_shardings`).

A spec is the reference's PartitionSpec as a tuple, one entry a dim:
None (replicated), a mesh dim name, or a tuple of names.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims, or a plain
mapping of dim name to size, so the rules are pure functions of shapes
and mesh sizes.  Where the reference hands back `NamedSharding`s and
lets GSPMD place the shards, the port's ranks hold their shards
themselves: `arena_shardings` returns each leaf's spec, and
`kv_head_range` the rank's contiguous part of the kv-head axis that
the spec puts on "model".

The contract (the reference's DESIGN.md §Serving ¶Multi-device):
exactly the kv-head axis of each KV leaf splits, on the "model" dim,
in contiguous blocks, so a GQA group never straddles a shard; a
"model" width that does not divide the head count replicates the leaf
(never a partial head split); leaves without a sequence axis (the SSM
state), the page table and slot metadata replicate.

`params_sharding`, `spec_for_path` and `batch_spec` (training
layouts) are not ported yet.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def model_coords(mesh) -> Tuple[int, int]:
    """(this rank's coordinate, width) on the mesh's "model" dim; (0, 1)
    without a mesh or without that dim; a mapping of sizes is rank 0's
    view."""
    if mesh is None or "model" not in mesh_sizes(mesh):
        return 0, 1
    n = mesh_sizes(mesh)["model"]
    return (0 if isinstance(mesh, Mapping)
            else mesh.get_local_rank("model")), n


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop the sharding of dims that their mesh dims do not divide."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
        out.append(ax if shape[i] % n == 0 else None)
    return tuple(out)


def cache_spec(mesh, ndim: int) -> Spec:
    """The reference's training-side KV cache layout (..., B, K, S, hd):
    the batch on ("pod", "data") or "data", the sequence (axis -2) on
    "model"."""
    b = ("pod", "data") if "pod" in mesh_sizes(mesh) else "data"
    spec = [None] * ndim
    spec[-4] = b
    spec[-2] = "model"
    return tuple(spec)


def kv_head_axis(batch_axis: int, seq_axis: Optional[int]) -> Optional[int]:
    """The kv-head axis of an attention cache leaf, or None: the axis
    just before the sequence axis ((.., B, K, T, hd) rows and (..,
    n_pages + 1, K, page_size, hd) pools alike, int4-packed pools too:
    packing halves hd only), where it lies after the batch axis; leaves
    without a sequence axis (SSM state) have none."""
    if seq_axis is None:
        return None
    h_ax = seq_axis - 1
    return h_ax if h_ax > batch_axis else None


def arena_leaf_spec(shape, batch_axis: int, seq_axis: Optional[int],
                    mesh) -> Spec:
    """One arena leaf's spec: its kv-head axis on "model" where the
    width divides it, every other dim replicated."""
    h_ax = kv_head_axis(batch_axis, seq_axis)
    if h_ax is None:
        return ()
    spec = [None] * len(shape)
    spec[h_ax] = "model"
    return sanitize_spec(tuple(spec), shape, mesh)


def arena_shardings(mesh, shapes: Sequence, batch_axes: Sequence[int],
                    seq_axes: Sequence[Optional[int]]):
    """The specs of an arena's cache leaves (aligned with the leaves):
    the reference's `arena_shardings` without the `NamedSharding`
    around each."""
    return [arena_leaf_spec(s, b, q, mesh)
            for s, b, q in zip(shapes, batch_axes, seq_axes)]


def kv_head_range(K: int, mesh, rank: Optional[int] = None
                  ) -> Optional[slice]:
    """This rank's (or ``rank``'s) contiguous kv heads of K on the
    mesh's "model" dim, or None where they replicate (no mesh, width 1,
    or a width that does not divide K): the part of the axis that
    `arena_leaf_spec` puts on "model", rank-major.  The arena sizes its
    pools, the engine cuts its tables and the attention picks its heads
    by this one rule."""
    r, n = model_coords(mesh)
    r = r if rank is None else rank
    if n <= 1 or K % n:
        return None
    return slice(r * (K // n), (r + 1) * (K // n))
