"""The serving mesh over torch.distributed (port of
`repro.launch.mesh`'s serving half: `make_serving_mesh`,
`make_host_mesh`), and the launch of one process a rank.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with dims
("data", "model") on the process group the caller set up
(`torch.distributed.init_process_group`, or `spawn` below).  The
"model" dim carries the kv-head split of the serving arena
(`sharding.rules`); every rank runs the same host scheduler.

Unlike the reference's `make_serving_mesh`, which degrades to the
one-device host mesh when the platform has fewer devices than asked,
this one raises: a mesh that silently drops to replication would hide
the devices it was asked to use.

`spawn(fn, n, args, device=)` starts n ranks with
`torch.multiprocessing.spawn`, each in a process group of world size
n: "gloo" with a `FileStore` rendezvous in a temporary directory on
the CPU, "nccl" with one GPU a rank on the card (fewer GPUs than ranks
raise), or ``backend="gloo"`` with ``device="cuda"`` to let ranks
share a card (collectives staged through the host).  `fn(rank,
*args)` must be importable from a module (spawn re-imports it).

The production meshes (`make_production_mesh`) belong to the training
shardings and are not ported yet.
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


def make_serving_mesh(n_model: int = 0, *, n_data: int = 1):
    """A ("data", "model") DeviceMesh of n_data x n_model ranks over the
    default process group (`n_model` 0: every rank not claimed by
    `n_data`).  A world of another size raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n_data = max(1, n_data)
    if n_model <= 0:
        n_model = max(1, world // n_data)
    if n_data * n_model != world:
        raise ValueError(
            f"a ({n_data}, {n_model}) serving mesh needs {n_data * n_model} "
            f"ranks; the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=AXES)


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
