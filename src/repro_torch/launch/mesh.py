"""Device meshes for the port: ``torch.distributed`` ranks laid out as the
reference's ``jax.sharding.Mesh`` (``repro/launch/mesh.py``), with its
names, shapes and axis rules.

A "device" is a rank. Every function here starts the default process
group if none exists (``init_world``): under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` in the environment) from ``env://``, else a world of one
from a ``HashStore``; ``nccl`` on the card, ``gloo`` for ``device="cpu"``.
A group that already exists is used as it is, with a mesh of device type
``cuda`` over ``nccl`` and ``cpu`` over any other backend: two processes
that share one card meet over ``gloo`` (``nccl`` refuses two ranks on one
GPU), and the solver still runs on the card in each.

Besides the reference's constructors and axis helpers this module holds
the few collectives the fleet solver and the planning service make over
a mesh (``gather_objects``, ``agree``). The process groups of a mesh's
data and model axes (``data_group``, ``model_group``) and the tensor
collectives of a model's forward (``all_reduce``, ``all_gather``) live in
``core.collectives``, which the model layer reads too; they are named
here as well. Importing it starts nothing.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.collectives import (all_gather, all_reduce, data_axes_of,
                                data_group, data_index, model_group)
from ..core.device import resolve_device

__all__ = ["make_production_mesh", "make_test_mesh", "data_axes_of",
           "data_shard_count", "resolve_mesh", "init_world", "build_mesh",
           "world_devices", "data_index", "data_group", "model_group",
           "all_reduce", "all_gather", "gather_objects", "agree"]

#: serialises the port's object collectives, all on the world's group:
#: services on threads share it, and two threads' collectives must not
#: interleave on it
_WORLD_LOCK = threading.Lock()


def init_world(device=None) -> None:
    """Start the default process group unless one exists: ``env://``
    under ``torchrun``, else a world of one from a ``HashStore``; ``nccl``
    on the card (``None`` = the card), ``gloo`` for the CPU."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def build_mesh(devices: Optional[Sequence[int]], shape: Tuple[int, ...],
               axes: Tuple[str, ...], device=None) -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (ranks; ``None`` = every rank of the world, in order). A rank left
    out of the mesh holds it with coordinate ``None``."""
    init_world(device)
    n = math.prod(shape)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None:
        return init_device_mesh(kind, shape, mesh_dim_names=axes)
    ranks = list(devices)[:n]
    # process groups order their members by rank: ascending ranks keep a
    # group's order the mesh's (the a2a's row gathers rely on it)
    if ranks != sorted(set(ranks)):
        raise ValueError(f"devices must be distinct ranks in ascending "
                         f"order, got {ranks}")
    return DeviceMesh(kind, torch.tensor(ranks, dtype=torch.int).reshape(
        shape), mesh_dim_names=axes)


def world_devices(devices: Optional[Sequence[int]], device=None
                  ) -> List[int]:
    """``devices``, or every rank of the world (started if need be)."""
    init_world(device)
    return list(devices) if devices is not None \
        else list(range(dist.get_world_size()))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The target fleet, the reference's 16 x 16 = 256 devices (here 32
    nodes of 8 H100s), axes (data, model); multi-pod = 2 pods = 512 with a
    leading "pod" axis. Needs a world of exactly that many ranks (the dry
    run's fake one, ``launch.dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_world(device)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{math.prod(shape)} ranks ({'x'.join(map(str, shape))}); this "
            f"one has {world}")
    return build_mesh(None, shape, axes, device)


def make_test_mesh(*, multi_pod: bool = False, devices=None,
                   device=None) -> DeviceMesh:
    """Scaled-down mesh with the same axis structure: ``(data, model)``
    with model 2 on an even count of devices (else 1), or with
    ``multi_pod`` ``(pod 2, data, model 2)``."""
    devs = world_devices(devices, device)
    n = len(devs)
    if multi_pod:
        model = pod = 2
        if n < pod * model:
            raise ValueError(
                f"make_test_mesh(multi_pod=True) needs at least "
                f"{pod * model} devices (pod=2 x model=2 with a "
                f"non-empty data axis); only {n} available")
        shape: Tuple[int, ...] = (pod, n // (pod * model), model)
        axes: Tuple[str, ...] = ("pod", "data", "model")
    else:
        model = 2 if n % 2 == 0 else 1
        shape, axes = (n // model, model), ("data", "model")
    return build_mesh(devices, shape, axes, device)


def data_shard_count(mesh: DeviceMesh) -> int:
    """How many ways the problem axis splits on ``mesh``: the product of
    every non-"model" axis size."""
    names = mesh.mesh_dim_names
    return math.prod(int(mesh.shape[names.index(a)])
                     for a in data_axes_of(mesh))


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank of the world
    (``all_gather_object``, host side on any backend)."""
    out: List[Any] = [None] * dist.get_world_size()
    with _WORLD_LOCK:
        dist.all_gather_object(out, obj)
    return out


def agree(mesh: Optional[DeviceMesh], obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank of the world when solves run over
    ``mesh`` (else ``obj``): a host decision taken from a clock, a thread
    or a shared cache is made once and broadcast, so every rank issues the
    same collectives."""
    if mesh is None:
        return obj
    box = [obj]
    with _WORLD_LOCK:
        dist.broadcast_object_list(box, src=0)
    return box[0]


def resolve_mesh(name: Optional[str], device=None) -> Optional[DeviceMesh]:
    """CLI spelling -> mesh: "none"/None (one device), "host" (the test
    mesh over the world's ranks), "prod" (the 16x16 pod: a world of 256
    ranks)."""
    if name is None or name == "none":
        return None
    if name == "host":
        return make_test_mesh(device=device)
    if name == "prod":
        return make_production_mesh(device=device)
    raise ValueError(f"unknown mesh {name!r} "
                     f"(expected one of: none, host, prod)")
