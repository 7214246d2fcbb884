"""The process groups of a device mesh (``launch.mesh``) and the tensor
collectives of a model's forward on one.

A mesh's data axes (``data_axes_of``, ``data_index``, ``data_group``) and
its model axis (``model_group``: tensor parallelism's group), and
``all_reduce`` / ``all_gather`` over such a group, where GSPMD places
them in the reference. Over ``nccl`` they run on the card; a ``gloo``
group takes no card tensor for every collective, so there a card tensor
goes through host memory (two processes sharing one card meet over
``gloo``). The model layer (``models.layers.Sharding``, ``models.moe``)
and the launch layer (``launch.mesh``) both read them from here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["data_axes_of", "data_index", "data_group", "model_group",
           "all_reduce", "all_gather"]


def data_axes_of(mesh) -> Tuple[str, ...]:
    """Batch-sharding axes: ("pod", "data") on a multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def data_index(mesh, axes: Optional[Tuple[str, ...]] = None
               ) -> Optional[int]:
    """This rank's flat coordinate over the data axes (``axes``, default
    every non-"model" axis), row-major as the reference's
    ``P(data_axes)`` splits; ``None`` for a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    names = mesh.mesh_dim_names
    idx = 0
    for a in (data_axes_of(mesh) if axes is None else axes):
        i = names.index(a)
        idx = idx * int(mesh.shape[i]) + int(coord[i])
    return idx


def data_group(mesh, axes: Tuple[str, ...]):
    """The process group over the ``axes`` of ``mesh`` through this rank
    (one axis: the mesh's own group; several: one group per fixed
    coordinate of the others, made once per mesh, collectively)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        names = mesh.mesh_dim_names
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        ranks = mesh.mesh.permute(*rest, *keep).reshape(
            -1, math.prod(int(mesh.shape[i]) for i in keep))
        cache[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return cache[axes]


def model_group(mesh, axis: str = "model"):
    """The process group over the model axis of ``mesh`` through this rank
    (tensor parallelism's group)."""
    return mesh.get_group(axis)


def _via_host(t: torch.Tensor, group) -> bool:
    """A card tensor over a ``gloo`` group goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The sum (or ``op``) of every rank's ``t`` over ``group``, as a new
    tensor."""
    if _via_host(t, group):
        h = t.detach().cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` over ``group``, concatenated along ``dim`` in
    the group's rank order."""
    n = dist.get_world_size(group)
    src = t.detach().cpu() if _via_host(t, group) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)
