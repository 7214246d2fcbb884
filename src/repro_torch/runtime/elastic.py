"""Elastic re-meshing policy: a copy of ``best_mesh_shape`` from
``repro/runtime/elastic.py`` (plain Python).

Keep the model axis fixed (parameter shards must fit) and shrink the data
axis to ``n_devices // model``. Building the mesh itself
(``elastic_mesh``) waits for ROADMAP queue A item 13.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["best_mesh_shape"]


def best_mesh_shape(n_devices: int, model: int,
                    pod: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) using <= n_devices with fixed model/pod
    axes. Raises if not even one data row fits."""
    if n_devices < model * pod:
        raise ValueError(
            f"{n_devices} devices cannot host model={model} x pod={pod}")
    data = n_devices // (model * pod)
    return (pod, data, model) if pod > 1 else (data, model)
