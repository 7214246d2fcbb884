"""Turn a per-layer placement into contiguous pipeline stages.

The offloading assignment maps each layer independently; real execution
wants *contiguous* stages (one network hop per cut, monotone over the
topological order). ``contiguous_stages`` walks layers in topological
order and cuts wherever the assigned server changes — for chain DAGs
(every LM lowering) this is exact; for branching DAGs (enc-dec) stages
are cut on the topo-linearized order, which preserves every data
dependency (a stage only consumes outputs of earlier stages).

``stage_cut_cost`` prices a stage plan (boundary MB / bandwidth + per-
stage compute) so §Perf can compare the PSO-GA plan against uniform
depth-split baselines.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .dag import LayerDAG, topological_order
from .environment import Environment

__all__ = ["Stage", "contiguous_stages", "stage_cut_cost",
           "uniform_stages"]


class Stage(NamedTuple):
    server: int
    layers: np.ndarray          # layer ids, topologically ordered


def contiguous_stages(dag: LayerDAG, x: np.ndarray) -> List[Stage]:
    order = topological_order(dag)
    x = np.asarray(x)
    stages: List[Stage] = []
    cur_srv, cur_layers = int(x[order[0]]), [int(order[0])]
    for j in order[1:]:
        s = int(x[j])
        if s == cur_srv:
            cur_layers.append(int(j))
        else:
            stages.append(Stage(cur_srv, np.asarray(cur_layers)))
            cur_srv, cur_layers = s, [int(j)]
    stages.append(Stage(cur_srv, np.asarray(cur_layers)))
    return stages


def uniform_stages(dag: LayerDAG, servers: List[int]) -> np.ndarray:
    """Baseline: split the topo order into len(servers) equal-compute
    chunks (classic pipeline partitioning ignoring cost/bandwidth).
    Returns a per-layer assignment vector."""
    order = topological_order(dag)
    total = dag.compute.sum()
    per = total / len(servers)
    x = np.zeros(dag.num_layers, np.int64)
    acc, si = 0.0, 0
    for j in order:
        if acc >= per * (si + 1) and si < len(servers) - 1:
            si += 1
        x[j] = servers[si]
        acc += dag.compute[j]
    return x


def stage_cut_cost(dag: LayerDAG, env: Environment, x: np.ndarray
                   ) -> dict:
    """Boundary traffic + per-server compute seconds for a placement."""
    x = np.asarray(x)
    cross_mb = 0.0
    cross_s = 0.0
    for (u, v), mb in zip(dag.edges, dag.edge_mb):
        su, sv = int(x[u]), int(x[v])
        if su != sv:
            cross_mb += float(mb)
            bw = env.bandwidth[su, sv]
            cross_s += float(mb) / bw if bw > 0 else float("inf")
    comp_s = {}
    for j in range(dag.num_layers):
        s = int(x[j])
        comp_s[s] = comp_s.get(s, 0.0) + dag.compute[j] / env.power[s]
    return {"cross_mb": cross_mb, "cross_seconds": cross_s,
            "compute_seconds": comp_s,
            "n_stages": len(contiguous_stages(dag, x))}
