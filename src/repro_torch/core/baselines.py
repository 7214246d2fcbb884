"""Baselines the paper compares with (§V-B), ported from
``repro.core.baselines``.

* ``greedy_offload``   — offload each layer (topological order) to the
  cheapest server that keeps the *partial* schedule within its deadline;
  fall back to next-cheapest (paper's modified Greedy [24]).
* ``run_ga``           — genetic algorithm with tournament selection,
  two-point crossover and uniform mutation over the same encoding and the
  same 3-case fitness (paper's modified GA [18]); ``GAConfig``, and
  ``GADraws`` for the random numbers of one generation.
* ``run_pso_linear``   — PSO with the same GA operators but the *linear*
  inertia schedule of Eq. 21 (the non-adaptive ablation; "PSO" in Fig. 8d).
* ``heft_makespan``    — HEFT [35]; the paper derives every deadline as
  D_i = r_i · H(G_i) with r ∈ {1.2, 1.5, 3, 5, 8} (Eq. 24).
* ``pre_pso``          — preprocessing (Alg. 1) + PSO-GA, expanded back to
  per-original-layer placement ("prePSO").

The greedy and HEFT are numpy, copied. The GA, PSO and prePSO score every
particle through the replay kernels (B1, and B2 under traffic) on a CUDA
device, through their plain versions on the CPU; their random numbers are
injectable as for PSO-GA.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.schedule_sim import schedule_replay
from .batch import SYNC_EVERY, _solve_fleet
from .dag import LayerDAG, preprocess, topological_order
from .device import resolve_device
from .environment import Environment
from .fitness import INFEASIBLE_OFFSET, make_swarm_fitness
from .pso_ga import DrawFn, PSOGAConfig, PSOGAResult, run_pso_ga
from .simulator import SimProblem, kernel_args, pad_problem, simulate_np

__all__ = ["greedy_offload", "run_ga", "run_pso_linear", "heft_makespan",
           "pre_pso", "GAConfig", "GADraws"]


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


# ---------------------------------------------------------------------------
# GA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GAConfig:
    """The GA's settings. The replay runs where the tensors live (the
    kernels on a card, their plain versions on the CPU), so there is no
    fitness-backend field."""
    pop_size: int = 100
    max_iters: int = 1000
    stall_iters: int = 50
    tournament: int = 3
    p_crossover: float = 0.9
    p_mutation: float = 0.02          # per-gene
    elite: int = 2
    faithful_sim: bool = False        # match PSOGAConfig (paper-consistent)
    miss_budget: float = 0.05         # p95 miss budget of the traffic key
    #   (consulted when run_ga gets ``arrivals``)


class GADraws(NamedTuple):
    """The random numbers of one GA generation (``baselines.py:157-170``
    of the reference):

      * ``cand (P, 2, T)`` int32 tournament entrants in ``[0, P)``;
      * ``do_x (P,)`` uniform: cross over where ``do_x < p_crossover``;
      * ``seg (P, 2)`` int32 crossover segment ends in ``[0, p)``;
      * ``mu (P, p)`` uniform: mutate a gene where ``mu < p_mutation``;
      * ``vals (P, p)`` int32 mutation servers in ``[0, S)``.
    """
    cand: torch.Tensor
    do_x: torch.Tensor
    seg: torch.Tensor
    mu: torch.Tensor
    vals: torch.Tensor


def _ga_draws(g: torch.Generator, P: int, T: int, p: int, s: int,
              dev: torch.device) -> GADraws:
    def ints(high, shape):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=torch.int32)
    return GADraws(cand=ints(P, (P, 2, T)),
                   do_x=torch.rand((P,), generator=g, device=dev),
                   seg=ints(p, (P, 2)),
                   mu=torch.rand((P, p), generator=g, device=dev),
                   vals=ints(s, (P, p)))


def _as_draws(d: GADraws, dev: torch.device) -> GADraws:
    """Draws from anything numpy reads, as float32 / int32 on ``dev``."""
    def conv(v, dtype):
        t = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        return t.to(device=dev, dtype=dtype)
    return GADraws(*(conv(v, torch.float32 if name in ("do_x", "mu")
                          else torch.int32)
                     for name, v in zip(GADraws._fields, d)))


class _GAState(NamedTuple):
    X: torch.Tensor              # (P, p) int32
    f: torch.Tensor              # (P,) f32
    best_f: torch.Tensor         # () f32
    stall: torch.Tensor          # () int32
    it: torch.Tensor             # () int32


def run_ga(dag: LayerDAG, env: Environment, cfg: GAConfig = GAConfig(),
           seed: int = 0, arrivals: Optional[np.ndarray] = None,
           device: Optional[Union[str, torch.device]] = None,
           X0: Optional[np.ndarray] = None,
           draw_fn: Optional[Callable[[int], GADraws]] = None
           ) -> PSOGAResult:
    """Paper's modified GA on ``device`` (``None`` = the card).

    ``X0`` (``(pop_size, p)``) replaces the initial population and
    ``draw_fn(generation)`` each generation's ``GADraws``; by default both
    come from a ``torch.Generator`` seeded with ``seed``. ``arrivals``
    (``(M, n_apps, R)``) switch the fitness to the queue-aware traffic key
    under ``cfg.miss_budget``, so the baseline competes with PSO-GA under
    the same request stream; ``best_cost`` and ``feasible`` report the
    zero-load replay of the winner either way.

    Each generation is one replay launch for the whole population. The
    stop rule (``max_iters``, or ``stall_iters`` generations without a new
    best) is checked on the host every ``SYNC_EVERY`` generations; a
    stopped population is frozen in between, so ``iterations`` is exact.
    """
    dev = resolve_device(device)
    prob = SimProblem.build(dag, env)
    pp = pad_problem(prob, device=dev)
    fit = make_swarm_fitness(pp, cfg.faithful_sim, arrivals=arrivals,
                             miss_budget=cfg.miss_budget)
    pinned = torch.as_tensor(prob.pinned, device=dev)
    p, s, P = prob.num_layers, prob.num_servers, cfg.pop_size
    genes = torch.arange(p, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def clamp(X: torch.Tensor) -> torch.Tensor:
        return torch.where(pinned >= 0, pinned, X).to(torch.int32)

    if X0 is None:
        X = torch.randint(0, s, (P, p), generator=g, device=dev,
                          dtype=torch.int32)
    else:
        X = torch.tensor(np.asarray(X0), dtype=torch.int32, device=dev)
        if tuple(X.shape) != (P, p):
            raise ValueError(f"initial population has shape "
                             f"{tuple(X.shape)}, expected {(P, p)}")
    X = clamp(X)
    f = fit(X)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = _GAState(X=X, f=f, best_f=f.min(), stall=zero, it=zero)

    def done(st: _GAState) -> torch.Tensor:
        return (st.it >= cfg.max_iters) | (st.stall >= cfg.stall_iters)

    def generation(st: _GAState, d: GADraws) -> _GAState:
        # tournament selection: the first fittest of T entrants, twice
        win = st.f[d.cand.long()].argmin(-1, keepdim=True)      # (P, 2, 1)
        parents = d.cand.gather(-1, win)[..., 0].long()         # (P, 2)
        pa, pb = st.X[parents[:, 0]], st.X[parents[:, 1]]
        # two-point crossover
        lo = d.seg.amin(-1, keepdim=True)
        hi = d.seg.amax(-1, keepdim=True)
        in_seg = (genes >= lo) & (genes <= hi)
        child = torch.where(in_seg & (d.do_x < cfg.p_crossover)[:, None],
                            pb, pa)
        # uniform mutation
        child = clamp(torch.where(d.mu < cfg.p_mutation, d.vals, child))
        f_new = fit(child)
        # elitism: the previous generation's best (stable order, as
        # jnp.argsort: ties among infeasible keys are common)
        elite = torch.argsort(st.f, stable=True)[:cfg.elite]
        child = torch.cat([st.X[elite], child[cfg.elite:]])
        f_new = torch.cat([st.f[elite], f_new[cfg.elite:]])
        new_best = f_new.min()
        improved = new_best < st.best_f
        return _GAState(
            X=child, f=f_new, best_f=torch.minimum(st.best_f, new_best),
            stall=torch.where(improved, zero, st.stall + 1), it=st.it + 1)

    for gen in range(cfg.max_iters):
        if gen % SYNC_EVERY == 0 and bool(done(state)):
            break
        d = _ga_draws(g, P, cfg.tournament, p, s, dev) if draw_fn is None \
            else _as_draws(draw_fn(gen), dev)
        frozen = done(state)
        state = _GAState(*(torch.where(frozen, old, new) for new, old in
                           zip(generation(state, d), state)))
    i = int(state.f.argmin())
    total, feas, _ = schedule_replay(*kernel_args(pp),
                                     state.X[i].reshape(1, 1, p).contiguous(),
                                     faithful=cfg.faithful_sim)
    ok = bool(feas[0, 0])
    return PSOGAResult(best_x=state.X[i].cpu().numpy(),
                       best_fitness=float(state.f[i]),
                       best_cost=float(total[0, 0]) if ok else float("inf"),
                       feasible=ok, iterations=int(state.it), history=None)


# ---------------------------------------------------------------------------
# PSO with linear inertia (Eq. 21) — the non-adaptive ablation
# ---------------------------------------------------------------------------

def run_pso_linear(dag: LayerDAG, env: Environment,
                   cfg: PSOGAConfig = PSOGAConfig(), seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None,
                   X0: Optional[np.ndarray] = None,
                   draw_fn: Optional[DrawFn] = None) -> PSOGAResult:
    """Same operators as PSO-GA but w follows Eq. 21 (linear decay):
    ``w_max − (w_max − w_min)·it/max_iters``, one value for the whole
    swarm. Cold init, zero-load key; ``X0`` and ``draw_fn(0, step)`` as
    for ``run_pso_ga`` (the step draws are PSO-GA's ``SwarmDraws``)."""
    return _solve_fleet([(dag, env)], cfg, seed, False, device,
                        None if X0 is None else [X0], draw_fn, False, None,
                        linear_inertia=True)[0]


# ---------------------------------------------------------------------------
# HEFT
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# prePSO
# ---------------------------------------------------------------------------

def pre_pso(dag: LayerDAG, env: Environment,
            cfg: PSOGAConfig = PSOGAConfig(), seed: int = 0,
            device: Optional[Union[str, torch.device]] = None,
            X0: Optional[np.ndarray] = None,
            draw_fn: Optional[DrawFn] = None) -> PSOGAResult:
    """Alg. 1 preprocessing, PSO-GA on the compressed DAG, then expansion
    of the placement back to original layers (every member of a merged
    group runs on the group's server). ``X0`` and ``draw_fn`` feed the
    solve on the compressed DAG."""
    small, group = preprocess(dag)
    res = run_pso_ga(small, env, cfg, seed=seed, device=device, X0=X0,
                     draw_fn=draw_fn)
    expanded = res.best_x[group]
    # re-evaluate on the ORIGINAL problem: merged execution removes
    # intra-group transfers, which is what same-server placement does in
    # the original DAG too
    prob = SimProblem.build(dag, env)
    r = simulate_np(prob, expanded, faithful=cfg.faithful_sim)
    ok = bool(r.feasible)
    return PSOGAResult(best_x=expanded.astype(np.int32),
                       best_fitness=float(r.total_cost) if ok
                       else float(INFEASIBLE_OFFSET + r.app_completion.sum()),
                       best_cost=float(r.total_cost) if ok else float("inf"),
                       feasible=ok, iterations=res.iterations, history=None)
