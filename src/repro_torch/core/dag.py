"""Layer-DAG model for DNN-based applications (paper §III-A).

A DNN is a directed acyclic graph G = (L, E, D):
  * L — layers l_j = <a_j, i_j, o_j> with compute amount ``a_j`` (work
    units; execution time on server k is ``a_j / p_k``, Eq. 4),
  * E — data dependencies e^{j,k},
  * D — datasets: one dataset per edge with size in MB (Eq. 6 divides
    by bandwidth in MB/s).

``LayerDAG`` also carries per-layer *pinning* (the paper pins each DNN's
input layer to its originating end device, Fig. 2) and the owning
application id + deadline, so several DNNs can be scheduled jointly as one
flat problem (the paper's "three DNNs per end device" experiments).

Algorithm 1 (preprocessing) contracts *cut-edges*: an edge (u, v) where
out-degree(u) == 1 and in-degree(v) == 1 is merged into a single layer
whose compute amount is the sum and whose external edges are re-wired.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LayerDAG", "preprocess", "merge_dags", "topological_order"]


@dataclasses.dataclass
class LayerDAG:
    """A flat, numpy-backed layer DAG (possibly the union of many DNNs).

    Attributes:
      compute: (p,) float64 — compute amount a_j per layer (work units).
      edges: (E, 2) int32 — (src, dst) layer indices, src < dst is NOT
        required but the graph must be acyclic.
      edge_mb: (E,) float64 — dataset size in MB carried by each edge.
      app_id: (p,) int32 — which DNN-based application each layer belongs to.
      deadline: (n_apps,) float64 — D(G_i) per application (seconds).
      pinned: (p,) int32 — server index the layer MUST run on, or -1.
      names: optional layer names for debugging / reports.
    """

    compute: np.ndarray
    edges: np.ndarray
    edge_mb: np.ndarray
    app_id: np.ndarray
    deadline: np.ndarray
    pinned: np.ndarray
    names: Optional[List[str]] = None

    def __post_init__(self) -> None:
        self.compute = np.asarray(self.compute, dtype=np.float64)
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)
        self.edge_mb = np.asarray(self.edge_mb, dtype=np.float64)
        self.app_id = np.asarray(self.app_id, dtype=np.int32)
        self.deadline = np.atleast_1d(np.asarray(self.deadline, dtype=np.float64))
        self.pinned = np.asarray(self.pinned, dtype=np.int32)
        if self.edges.shape[0] != self.edge_mb.shape[0]:
            raise ValueError("edges and edge_mb length mismatch")
        if self.compute.shape[0] != self.app_id.shape[0]:
            raise ValueError("compute and app_id length mismatch")
        if self.compute.shape[0] != self.pinned.shape[0]:
            raise ValueError("compute and pinned length mismatch")

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return int(self.compute.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_apps(self) -> int:
        return int(self.deadline.shape[0])

    def in_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_layers, dtype=np.int64)
        if self.num_edges:
            np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def out_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_layers, dtype=np.int64)
        if self.num_edges:
            np.add.at(deg, self.edges[:, 0], 1)
        return deg

    def parents(self, j: int) -> np.ndarray:
        return self.edges[self.edges[:, 1] == j, 0]

    def children(self, j: int) -> np.ndarray:
        return self.edges[self.edges[:, 0] == j, 1]

    def total_compute(self) -> float:
        return float(self.compute.sum())

    def validate_acyclic(self) -> None:
        topological_order(self)  # raises on cycle

    def with_deadline(self, deadline: np.ndarray) -> "LayerDAG":
        return dataclasses.replace(self, deadline=np.asarray(deadline, np.float64))

    # Padded parent/child index tables used by the vectorized simulator.
    def padded_relatives(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (parent_idx, parent_mb, child_idx, child_mb).

        parent_idx: (p, max_in) int32, padded with -1.
        parent_mb:  (p, max_in) float64, padded with 0.
        child_idx / child_mb analogous for outgoing edges.
        """
        p = self.num_layers
        par: List[List[Tuple[int, float]]] = [[] for _ in range(p)]
        chi: List[List[Tuple[int, float]]] = [[] for _ in range(p)]
        for (u, v), mb in zip(self.edges, self.edge_mb):
            par[v].append((int(u), float(mb)))
            chi[u].append((int(v), float(mb)))
        max_in = max([len(x) for x in par] + [1])
        max_out = max([len(x) for x in chi] + [1])
        pi = np.full((p, max_in), -1, np.int32)
        pm = np.zeros((p, max_in), np.float64)
        ci = np.full((p, max_out), -1, np.int32)
        cm = np.zeros((p, max_out), np.float64)
        for j in range(p):
            for k, (u, mb) in enumerate(par[j]):
                pi[j, k], pm[j, k] = u, mb
            for k, (v, mb) in enumerate(chi[j]):
                ci[j, k], cm[j, k] = v, mb
        return pi, pm, ci, cm


def topological_order(dag: LayerDAG) -> np.ndarray:
    """Kahn's algorithm; deterministic (smallest index first). Raises on cycle."""
    p = dag.num_layers
    indeg = dag.in_degree().copy()
    children: List[List[int]] = [[] for _ in range(p)]
    for u, v in dag.edges:
        children[int(u)].append(int(v))
    import heapq

    ready = [j for j in range(p) if indeg[j] == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        j = heapq.heappop(ready)
        order.append(j)
        for c in children[j]:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(ready, c)
    if len(order) != p:
        raise ValueError("graph has a cycle")
    return np.asarray(order, dtype=np.int32)


def preprocess(dag: LayerDAG) -> Tuple[LayerDAG, np.ndarray]:
    """Algorithm 1 — merge adjacent layers joined by a cut-edge.

    An edge (u, v) is a *cut-edge* when out-degree(u) == 1 and
    in-degree(v) == 1 **and** u, v belong to the same application.
    Merging repeats until no cut-edge remains. The merged layer's compute
    amount is the sum of the group's; the intra-group datasets vanish
    (they never cross servers after merging — Fig. 3(a)).

    Returns (new_dag, group) where ``group[j]`` maps original layer j to
    its merged layer index (usable to expand a compressed placement back
    to per-original-layer placement).
    """
    p = dag.num_layers
    group = np.arange(p, dtype=np.int64)  # union-find
    out_deg = dag.out_degree()
    in_deg = dag.in_degree()

    def find(x: int) -> int:
        while group[x] != x:
            group[x] = group[group[x]]
            x = int(group[x])
        return x

    # A cut-edge's endpoints merge; degrees are on the ORIGINAL graph, which
    # is exactly Alg. 1's fixed point: repeated merging of chains u→v with
    # outdeg(u)==indeg(v)==1 unions every maximal chain into one node.
    for (u, v), _mb in zip(dag.edges, dag.edge_mb):
        u, v = int(u), int(v)
        if out_deg[u] == 1 and in_deg[v] == 1 and dag.app_id[u] == dag.app_id[v]:
            ru, rv = find(u), find(v)
            if ru != rv:
                group[rv] = ru

    roots = np.array([find(j) for j in range(p)], dtype=np.int64)
    uniq, new_index = np.unique(roots, return_inverse=True)
    q = uniq.shape[0]

    compute = np.zeros(q, np.float64)
    np.add.at(compute, new_index, dag.compute)
    app_id = np.zeros(q, np.int32)
    app_id[new_index] = dag.app_id  # all members share app id
    pinned = np.full(q, -1, np.int32)
    for j in range(p):
        if dag.pinned[j] >= 0:
            g = new_index[j]
            if pinned[g] >= 0 and pinned[g] != dag.pinned[j]:
                raise ValueError("merged group has conflicting pins")
            pinned[g] = dag.pinned[j]

    # Re-wire surviving edges (those crossing groups); keep parallel edges
    # collapsed by summing MB (both datasets must cross the same link).
    edge_map: Dict[Tuple[int, int], float] = {}
    for (u, v), mb in zip(dag.edges, dag.edge_mb):
        gu, gv = int(new_index[int(u)]), int(new_index[int(v)])
        if gu == gv:
            continue
        edge_map[(gu, gv)] = edge_map.get((gu, gv), 0.0) + float(mb)
    if edge_map:
        edges = np.array(sorted(edge_map.keys()), np.int32)
        edge_mb = np.array([edge_map[tuple(e)] for e in edges], np.float64)
    else:
        edges = np.zeros((0, 2), np.int32)
        edge_mb = np.zeros((0,), np.float64)

    names = None
    if dag.names is not None:
        names = ["+".join(dag.names[j] for j in range(p) if new_index[j] == g)
                 for g in range(q)]
    new_dag = LayerDAG(compute=compute, edges=edges, edge_mb=edge_mb,
                       app_id=app_id, deadline=dag.deadline.copy(),
                       pinned=pinned, names=names)
    return new_dag, new_index.astype(np.int64)


def merge_dags(dags: Sequence[LayerDAG]) -> LayerDAG:
    """Concatenate several applications into one flat scheduling problem."""
    offset_l = 0
    offset_a = 0
    computes, edges, mbs, apps, pins, deadlines, names = [], [], [], [], [], [], []
    any_names = any(d.names is not None for d in dags)
    for d in dags:
        computes.append(d.compute)
        if d.num_edges:
            edges.append(d.edges + offset_l)
            mbs.append(d.edge_mb)
        apps.append(d.app_id + offset_a)
        pins.append(d.pinned)
        deadlines.append(d.deadline)
        if any_names:
            names.extend(d.names if d.names is not None
                         else [f"l{offset_l + j}" for j in range(d.num_layers)])
        offset_l += d.num_layers
        offset_a += d.num_apps
    return LayerDAG(
        compute=np.concatenate(computes),
        edges=np.concatenate(edges) if edges else np.zeros((0, 2), np.int32),
        edge_mb=np.concatenate(mbs) if mbs else np.zeros((0,), np.float64),
        app_id=np.concatenate(apps),
        deadline=np.concatenate(deadlines),
        pinned=np.concatenate(pins),
        names=names if any_names else None,
    )
