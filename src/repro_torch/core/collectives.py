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

Every tensor collective of the model and train paths goes through this
module (``all_reduce``, ``all_gather``, ``all_to_all``), and so does its
backward where it has one. ``record_collectives()`` makes each of them
append a ``Collective(op, result_bytes, ranks)`` while it is open: the
HLO op it stands for (``all-reduce``, ``all-gather``, ``all-to-all``), the
bytes of its result as the HLO's result shape counts them (the gathered
tensor of an all-gather) and the global ranks of its group in group
order. ``launch.analysis.trace_step`` prices them as the reference prices
the collectives of a compiled program. Off, a collective costs one test.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["data_axes_of", "data_index", "data_group", "model_group",
           "all_reduce", "all_gather", "all_to_all", "Collective",
           "record_collectives"]


class Collective(NamedTuple):
    """One collective as it ran: the HLO op it stands for, its result's
    bytes and its group's global ranks."""
    op: str
    result_bytes: int
    ranks: Tuple[int, ...]


#: the list ``record_collectives`` appends to; ``None`` when off
_RECORDS: Optional[List[Collective]] = None


@contextlib.contextmanager
def record_collectives():
    """Collect every collective this process issues (on any thread) into
    the list it yields, until the block ends."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _note(op: str, result_bytes: int, group) -> None:
    if _RECORDS is not None:
        _RECORDS.append(Collective(
            op, result_bytes, tuple(dist.get_process_group_ranks(group))))


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
    _note("all-reduce", t.numel() * t.element_size(), group)
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
    _note("all-gather", n * src.numel() * src.element_size(), group)
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal splits; the backward is the reverse
    exchange of the gradient (as ``torch.distributed.nn``'s)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    _note("all-to-all", out.numel() * out.element_size(), group)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rows of ``x`` in equal blocks, block ``j`` sent to the group's
    ``j``-th rank, the received blocks in rank order; autograd-aware."""
    return _AllToAll.apply(x, group)
