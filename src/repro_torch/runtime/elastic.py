"""Elastic re-meshing, ported from ``repro/runtime/elastic.py``: rebuild
the largest valid mesh from the ranks that are alive.

Policy: keep the model axis fixed (parameter shards must fit) and shrink
the data axis to ``n_devices // model``. A rank left out of a mesh smaller
than the world holds it with coordinate ``None``: the fleet solver gives it
no rows and hands it the results all the same.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["best_mesh_shape", "elastic_mesh"]


def best_mesh_shape(n_devices: int, model: int,
                    pod: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) using <= n_devices with fixed model/pod
    axes. Raises if not even one data row fits."""
    if n_devices < model * pod:
        raise ValueError(
            f"{n_devices} devices cannot host model={model} x pod={pod}")
    data = n_devices // (model * pod)
    return (pod, data, model) if pod > 1 else (data, model)


def elastic_mesh(model: int, pod: int = 1,
                 devices: Optional[Sequence[int]] = None, device=None):
    """The ``best_mesh_shape`` mesh over ``devices`` (ranks; ``None`` =
    the world), axes ``(data, model)`` or ``(pod, data, model)``; starts
    the world as ``launch.mesh.init_world`` does (``device=None``: the
    card). ``launch.serve.Server``'s mesh when ``model_axis > 1``, as the
    reference's."""
    from ..launch.mesh import build_mesh, world_devices
    shape = best_mesh_shape(len(world_devices(devices, device)), model, pod)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    return build_mesh(devices, shape, axes, device)
