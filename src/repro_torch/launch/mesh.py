"""Meshes over torch.distributed (port of `repro.launch.mesh`:
`make_production_mesh`, `make_serving_mesh`, `make_host_mesh`), and
the launch of one process a rank.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
on the process group the caller set up
(`torch.distributed.init_process_group`, or `spawn` below):

  production  (16, 16) ("data", "model"), 256 ranks, or with
              ``multi_pod`` (2, 16, 16) ("pod", "data", "model"), 512
              ranks: the training and dry-run layouts
              (`sharding.rules`; "pod" carries data parallelism across
              pods, "model" tensor, expert and sequence sharding)
  serving     (d, m) ("data", "model"): "model" carries the kv-head
              split of the serving arena; every rank runs the same
              host scheduler

Unlike the reference's `make_serving_mesh`, which degrades to the
one-device host mesh when the platform has fewer devices than asked,
these raise where the world has another size: a mesh that silently
drops to replication would hide the devices it was asked to use.  The
dry run (`launch.dryrun`) builds the production meshes on a fake
process group of 256 or 512 ranks in one process.

`spawn(fn, n, args, device=)` starts n ranks with
`torch.multiprocessing.spawn`, each in a process group of world size
n: "gloo" with a `FileStore` rendezvous in a temporary directory on
the CPU, "nccl" with one GPU a rank on the card (fewer GPUs than ranks
raise), or ``backend="gloo"`` with ``device="cuda"`` to let ranks
share a card (collectives staged through the host).  `fn(rank,
*args)` must be importable from a module (spawn re-imports it).
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A DeviceMesh of `shape` with dim names `axes` over the default
    process group, whose world must be exactly its size.  Its device
    type (the device of the DTensors placed on it) is "cuda" under
    "nccl" and "cpu" otherwise, unless `device_type` names one: "cuda"
    for "gloo" ranks that share a card."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`; another world size raises."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), AXES)


def make_serving_mesh(n_model: int = 0, *, n_data: int = 1):
    """A ("data", "model") DeviceMesh of n_data x n_model ranks over the
    default process group (`n_model` 0: every rank not claimed by
    `n_data`).  A world of another size raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    n_data = max(1, n_data)
    if n_model <= 0:
        n_model = max(1, dist.get_world_size() // n_data)
    return make_mesh((n_data, n_model), AXES)


def make_host_mesh():
    """The (1, 1) mesh with the serving dims (a world of one rank)."""
    return make_serving_mesh(1, n_data=1)


def _rank_main(rank: int, n: int, backend: str, init_method: str,
               device: str, fn: Callable, args: Sequence):
    if device == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), *,
          device: str = "cuda", backend: Optional[str] = None):
    """Run `fn(rank, *args)` in n processes of one process group (see
    the module docstring); returns when every rank has ended, and
    raises if one failed."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise ValueError(f"{n} ranks need {n} GPUs; "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_main, args=(n, backend, init_method, device, fn,
                              tuple(args)), nprocs=n, join=True)
