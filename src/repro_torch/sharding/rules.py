"""Logical-axis sharding rules (port of `repro.sharding.rules`): the
training layouts (`_RULES`, `spec_for_path`, `params_sharding`,
`batch_spec`, `caches_sharding`) and the serving arena's
(`sanitize_spec`, `cache_spec`, `kv_head_axis`, `arena_leaf_spec`,
`arena_shardings`).

A spec is the reference's PartitionSpec as a tuple, one entry a dim:
None (replicated), a mesh dim name, or a tuple of names (``()`` is
P(), replicated whatever the rank).  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims, a plain
mapping of dim name to size, or anything with the reference mesh's
`axis_names` and `devices` (a duck-typed production mesh needs no
devices), so the rules are pure functions of shapes and mesh sizes.
Where the reference hands back `NamedSharding`s and lets GSPMD place
the shards, the port's ranks hold their shards themselves:
`params_sharding` and `caches_sharding` give each leaf a `Sharding`
(mesh, DTensor placements, spec), which `distribute_tensor` and
`sharding.place` take; `arena_shardings` returns each leaf's spec,
and `kv_head_range` the rank's contiguous part of the kv-head axis
that the spec puts on "model".

Training layout (2-D FSDP x TP, the reference's DESIGN.md §Sharding):
the batch on ("pod", "data"), vocab / heads / mlp / experts on
"model", a weight's d_model dim on "data".  The rules match the joined
param path (dict keys and list indices joined by "/", first hit wins)
and pad the spec with None for stacked leading dims, so one rule set
covers float params, FQ qstate, the ID tables and the Adam moments.
`to_placements` turns a spec into placements: `Shard(i)` on each mesh
dim that carries tensor dim i, `Replicate()` elsewhere; two mesh dims
on one tensor dim (("pod", "data")) shard in mesh-dim order, pod-major,
as JAX splits a tuple of axes.

The contract (the reference's DESIGN.md §Serving ¶Multi-device):
exactly the kv-head axis of each KV leaf splits, on the "model" dim,
in contiguous blocks, so a GQA group never straddles a shard; a
"model" width that does not divide the head count replicates the leaf
(never a partial head split); leaves without a sequence axis (the SSM
state), the page table and slot metadata replicate.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# (path regex, base spec in logical axes); first match wins; None: the
# expert tensors, whose spec depends on their rank (`_expert_spec`)
_RULES: Tuple[Tuple[str, Optional[Tuple]], ...] = (
    # embeddings / head
    (r"embed.*table", ("model", "data")),        # (vocab, d)
    (r"head.*w", ("data", "model")),             # (d, vocab)
    (r"head.*b_q", ("model",)),
    # MoE experts (E, d, f) / (E, f, d); router (d, E)
    (r"moe.*router.*w", ("data", None)),
    (r"(moe|segments).*w[gud](_q)?$", None),
    # attention
    (r"attn.*wo.*w", ("model", "data")),         # (H*hd, d)
    (r"attn.*w[qkv].*w", ("data", "model")),     # (d, H*hd)
    (r"attn.*w[qkv].*b_q", ("model",)),
    (r"attn.*wo.*b_q", ("data",)),
    # dense mlp
    (r"mlp.*wd.*w", ("model", "data")),          # (f, d)
    (r"mlp.*w[gu].*w", ("data", "model")),       # (d, f)
    (r"mlp.*w[gu].*b_q", ("model",)),
    (r"mlp.*wd.*b_q", ("data",)),
    # ssm
    (r"(core|mamba).*in_proj.*w", ("data", "model")),
    (r"(core|mamba).*out_proj.*w", ("model", "data")),
    (r"(core|mamba).*x_proj.*w", ("model", None)),
    (r"(core|mamba).*dt_proj.*w", (None, "model")),
    (r"(core|mamba).*in_proj.*b_q", ("model",)),
    (r"(core|mamba).*out_proj.*b_q", ("data",)),
    (r"conv_w", (None, "model")),
    (r"A_log", ("model", None)),
    (r"A$", ("model", None)),
    # per-channel requant tables follow their producer's out axis
    (r"attn.*(q_rqt|k_rqt|v_rqt)", ("model",)),
    (r"(u_rqt|h_rqt|g_rqt|o_rqt)", ("model",)),
    (r"(xz_rqt|p_rqt|xdb_rqt|conv_rqt)", ("model",)),
)


class Sharding(NamedTuple):
    """One leaf's placement: the mesh, its DTensor placements (one a
    mesh dim) and the spec they come from.  `distribute_tensor(x,
    s.mesh, s.placements)` places a full tensor by it."""
    mesh: Any
    placements: tuple
    spec: Spec


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a DeviceMesh, a duck-typed mesh
    (`axis_names`, `devices`), or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, np.shape(mesh.devices)))
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


def _logical_to_mesh(axis: Optional[str], mesh):
    if axis is None:
        return None
    if axis in ("data", "model"):
        return axis
    if axis == "batch":
        return ("pod", "data") if "pod" in mesh_sizes(mesh) else "data"
    raise ValueError(axis)


def _expert_spec(ndim_base: int) -> tuple:
    # (E, d, f) -> experts on model, d on data; (E, f, d) the same
    return ("model", "data", None) if ndim_base == 3 else ("data", "model")


def _path_str(path: Sequence) -> str:
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """fn(path, leaf) over a tree of dicts and lists (a path is the
    tuple of dict keys and list indices down to the leaf), the
    structure kept; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def spec_for_path(path: Sequence, leaf, mesh) -> Spec:
    """The spec of one param leaf (stacked leading dims replicated)."""
    ps = _path_str(path)
    shape = _shape(leaf)
    ndim = len(shape)
    if ndim == 0:
        return ()
    for pattern, base in _RULES:
        if re.search(pattern, ps):
            if base is None:  # expert tensors: rank-dependent
                base = _expert_spec(3) if ndim >= 3 else ("data", "model")
            base = tuple(_logical_to_mesh(a, mesh) for a in base)
            n_lead = ndim - len(base)
            if n_lead < 0:  # a table below the rule's rank: replicate
                return ()
            return sanitize_spec((None,) * n_lead + base, shape, mesh)
    return ()  # replicated by default (norm gains, LUTs, scalars)


def to_placements(spec: Spec, mesh) -> tuple:
    """A spec -> DTensor placements, one a mesh dim: `Shard(i)` where
    the mesh dim carries tensor dim i, else `Replicate()`.  A tuple of
    mesh dims on one tensor dim must name them in mesh-dim order (then
    DTensor splits pod-major, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = tuple(mesh_sizes(mesh))
    where = {}
    for i, ax in enumerate(spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        order = [dims.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"mesh dims {axes} on one tensor dim out of mesh order")
        for a in axes:
            where[a] = i
    return tuple(Shard(where[d]) if d in where else Replicate()
                 for d in dims)


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """The shape of one rank's shard of a leaf of `shape` under `spec`
    (every sharded dim divides: `sanitize_spec`)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for i, ax in enumerate(spec):
        for a in (() if ax is None else
                  (ax if isinstance(ax, tuple) else (ax,))):
            out[i] //= sizes[a]
    return tuple(out)


def shard_index(shape, spec: Spec, mesh, coords: Mapping[str, int]) -> tuple:
    """The slices of a full leaf that the rank at mesh coordinates
    `coords` ({dim name: index}) holds: a tuple of mesh dims on one
    tensor dim counts their coordinates major to minor."""
    sizes = mesh_sizes(mesh)
    idx = [slice(None)] * len(shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        chunk, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            chunk = chunk * sizes[a] + coords[a]
            n *= sizes[a]
        w = shape[i] // n
        idx[i] = slice(chunk * w, (chunk + 1) * w)
    return tuple(idx)


def sharding_of(spec: Spec, mesh) -> Sharding:
    return Sharding(mesh, to_placements(spec, mesh), tuple(spec))


def params_sharding(params, mesh, *, weight_stationary: bool = False):
    """A tree of `Sharding`s matching `params` (any tree of leaves with
    a shape: tensors, meta tensors, numpy arrays).

    weight_stationary: drop the FSDP "data" axis from the weight specs
    (replicated across "data"): the serving layout where weights stay
    put and only activations move."""
    def one(path, leaf):
        spec = spec_for_path(path, leaf, mesh)
        if weight_stationary:
            spec = tuple(None if ax == "data" else ax for ax in spec)
        return sharding_of(spec, mesh)

    return tree_map_with_path(one, params)


def batch_spec(mesh, ndim: int, batch_axis: int = 0, shape=None) -> Spec:
    """Tokens and activations: the batch dim over ("pod", "data")."""
    spec = [None] * ndim
    spec[batch_axis] = _logical_to_mesh("batch", mesh)
    if shape is not None:
        return sanitize_spec(tuple(spec), shape, mesh)
    return tuple(spec)


def caches_sharding(caches, mesh):
    """The reference's cache heuristic, a `Sharding` a leaf: a leaf of
    4 dims or more whose last path key holds "k" or "v" is
    sequence-sharded (`cache_spec`); every other leaf of 3 dims or
    more puts axis -3 (the SSM state's batch) on the batch axes; the
    rest replicate."""
    def one(path, leaf):
        last = _path_str(path).split("/")[-1]
        shape = _shape(leaf)
        nd = len(shape)
        if nd >= 4 and ("k" in last or "v" in last):
            return sharding_of(sanitize_spec(cache_spec(mesh, nd), shape,
                                             mesh), mesh)
        spec = [None] * nd
        if nd >= 3:
            spec[-3] = _logical_to_mesh("batch", mesh)
        return sharding_of(sanitize_spec(tuple(spec), shape, mesh), mesh)

    return tree_map_with_path(one, caches)


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
