"""Baselines the paper compares with (§V-B), ported from
``repro.core.baselines``: the numpy ones, copied.

* ``greedy_offload``   — offload each layer (topological order) to the
  cheapest server that keeps the *partial* schedule within its deadline;
  fall back to next-cheapest (paper's modified Greedy [24]).
* ``heft_makespan``    — HEFT [35]; the paper derives every deadline as
  D_i = r_i · H(G_i) with r ∈ {1.2, 1.5, 3, 5, 8} (Eq. 24).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .dag import LayerDAG, topological_order
from .environment import Environment
from .fitness import INFEASIBLE_OFFSET
from .pso_ga import PSOGAResult
from .simulator import SimProblem, simulate_np

__all__ = ["greedy_offload", "heft_makespan"]


def greedy_offload(dag: LayerDAG, env: Environment, faithful: bool = False
                   ) -> PSOGAResult:
    """Cheapest-server-first greedy (paper §V-B / Alg. 2 line 15).

    Incremental O(p · S · deg): per layer, candidate servers are tried in
    ascending rental rate (ties: descending power, then index); the first
    whose schedule keeps THIS layer's end time within its app deadline
    (exactly Alg. 2's per-layer check) wins. Outgoing-transfer busy time
    is charged to the parent's server when the child is placed (the
    information only exists then — same accounting Alg. 2 line 21 does
    once placements are known).
    """
    prob = SimProblem.build(dag, env)
    order = prob.order
    p, s = prob.num_layers, prob.num_servers
    pref = np.lexsort((np.arange(s), -env.power, env.cost_per_sec))
    x = np.full(p, -1, np.int64)
    lease = np.zeros(s)
    end = np.zeros(p)
    trans_cost = 0.0
    feasible = True

    for j in order:
        dl = prob.deadline[prob.app_id[j]]
        pars = prob.parent_idx[j]
        pmask = pars >= 0
        pidx = pars[pmask]
        pmb = prob.parent_mb[j][pmask]
        cands = ([int(prob.pinned[j])] if prob.pinned[j] >= 0 else
                 [int(c) for c in pref])
        placed_srv, placed_end = -1, np.inf
        for srv in cands:
            if pidx.size:
                psrv = x[pidx]
                if np.any(~prob.link_ok[psrv, srv] & (psrv != srv)):
                    continue
                tt = pmb * prob.inv_bw[psrv, srv]
                if faithful:
                    start = lease[srv] + tt.max()
                else:
                    start = max(lease[srv], float((end[pidx] + tt).max()))
            else:
                start = lease[srv]
            t_end = start + prob.compute[j] / prob.power[srv]
            if t_end <= dl or srv == cands[-1]:
                ok_here = t_end <= dl
                placed_srv, placed_end = srv, t_end
                if not ok_here:
                    feasible = False
                break
        x[j] = placed_srv
        end[j] = placed_end
        # this layer occupies its server; charge incoming-transfer wait to
        # the chosen server per the selected fidelity mode
        lease[placed_srv] = placed_end if not faithful else \
            lease[placed_srv] + prob.compute[j] / prob.power[placed_srv]
        # charge outgoing transfers of each parent now that the link is
        # known (Alg. 2 line 21's `transfer` term) + transmission cost
        if pidx.size:
            psrv = x[pidx]
            tt = pmb * prob.inv_bw[psrv, placed_srv]
            for k, pj in enumerate(pidx):
                if psrv[k] != placed_srv:
                    lease[psrv[k]] += tt[k]
            trans_cost += float(
                np.sum(prob.tran_cost[psrv, placed_srv] * pmb))

    res = simulate_np(prob, x, faithful=faithful)
    ok = bool(res.feasible) and feasible
    return PSOGAResult(best_x=x.astype(np.int32),
                       best_fitness=float(res.total_cost) if ok
                       else float(INFEASIBLE_OFFSET + res.app_completion.sum()),
                       best_cost=float(res.total_cost) if ok else float("inf"),
                       feasible=ok, iterations=1, history=None)


def heft_makespan(dag: LayerDAG, env: Environment
                  ) -> Tuple[float, np.ndarray]:
    """Classic HEFT [35]: upward-rank priority + earliest-finish-time
    server selection (non-insertion). Pinned layers stay pinned. Returns
    (makespan, assignment). Used for the deadline rule D_i = r_i · H(G_i).
    """
    prob = SimProblem.build(dag, env)
    p, s = prob.num_layers, prob.num_servers
    avg_exec = dag.compute[:, None] / env.power[None, :]
    w_bar = avg_exec.mean(axis=1)                         # (p,)
    # average comm rate over distinct-server pairs with real links
    off_diag = ~np.eye(s, dtype=bool)
    ok = prob.link_ok & off_diag
    inv_bw_avg = prob.inv_bw[ok].mean() if ok.any() else 0.0

    children = [[] for _ in range(p)]
    child_mb = [[] for _ in range(p)]
    for (u, v), mb in zip(dag.edges, dag.edge_mb):
        children[int(u)].append(int(v))
        child_mb[int(u)].append(float(mb))

    rank = np.zeros(p)
    for j in reversed(topological_order(dag)):
        best = 0.0
        for c, mb in zip(children[j], child_mb[j]):
            best = max(best, mb * inv_bw_avg + rank[c])
        rank[j] = w_bar[j] + best

    order = np.argsort(-rank, kind="stable")
    # respect topology: stable-sort by rank is not guaranteed topological
    # for general DAGs; enforce by Kahn with rank priority.
    import heapq
    indeg = dag.in_degree().copy()
    prio = {j: (-rank[j], j) for j in range(p)}
    ready = [prio[j] for j in range(p) if indeg[j] == 0]
    heapq.heapify(ready)
    sched_order = []
    while ready:
        _, j = heapq.heappop(ready)
        sched_order.append(j)
        for c in children[j]:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(ready, prio[c])

    parents = [[] for _ in range(p)]
    parent_mb = [[] for _ in range(p)]
    for (u, v), mb in zip(dag.edges, dag.edge_mb):
        parents[int(v)].append(int(u))
        parent_mb[int(v)].append(float(mb))

    ready_srv = np.zeros(s)
    aft = np.zeros(p)
    x = np.zeros(p, np.int64)
    for j in sched_order:
        cands = ([int(prob.pinned[j])] if prob.pinned[j] >= 0
                 else list(range(s)))
        best_ft, best_srv = np.inf, cands[0]
        for srv in cands:
            gate = ready_srv[srv]
            bad = False
            for pj, mb in zip(parents[j], parent_mb[j]):
                if x[pj] != srv and not prob.link_ok[x[pj], srv]:
                    bad = True
                    break
                gate = max(gate, aft[pj] + mb * prob.inv_bw[x[pj], srv])
            if bad:
                continue
            ft = gate + dag.compute[j] / env.power[srv]
            if ft < best_ft:
                best_ft, best_srv = ft, srv
        x[j] = best_srv
        aft[j] = best_ft
        ready_srv[best_srv] = best_ft
    return float(aft.max() if p else 0.0), x
