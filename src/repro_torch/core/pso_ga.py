"""PSO-GA — self-adaptive discrete PSO with GA operators (paper §IV-B),
ported from ``repro.core.pso_ga``: cold and warm (incumbent-seeded)
solves, with or without traffic.

The particle position is the server-assignment vector (the order genes φ
are frozen to the topological order). One iteration applies, per particle
(Eq. 17–20):

    A = w  ⊕ Mu(X)            mutation       (inertia component)
    B = c1 ⊕ Cp(A, pBest)     crossover      (individual cognition)
    C = c2 ⊕ Cg(B, gBest)     crossover      (social cognition)

with the self-adaptive inertia weight (Eq. 22–23)

    w = w_max − (w_max − w_min) · exp(d / (d − 1.01)),
    d = div(gBest, X) / p_dims       (fraction of differing genes)

and acceleration coefficients ramping linearly (c1 0.9→0.2, c2 0.4→0.9).

The random numbers of one step are gathered in ``SwarmDraws``; a step
takes them as an argument or draws them from a ``torch.Generator`` on the
solve's device, so a test can feed the reference's own draws. The
iteration loop lives in ``core.batch``: a single solve is the one-problem
case of the fleet loop, stopping when gBest is unchanged for
``stall_iters`` iterations or at ``max_iters``.

Public surface: ``PSOGAConfig`` (with the warm-start fields
``warm_elite`` / ``warm_fraction`` / ``warm_mutation``), ``PSOGAResult``,
``SwarmDraws``, ``init_swarm`` (cold, incumbent and rescue modes),
``swarm_step`` (with the migration-aware warm key and an inertia override
for the linear schedule of ``baselines.run_pso_linear``), ``run_pso_ga``,
``draw_swarm``, ``draws_from_uniforms`` and ``state_from_arrays``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .dag import LayerDAG
from .device import resolve_device
from .environment import Environment
from .fitness import make_swarm_fitness
from .simulator import PaddedProblem, SimProblem
from .telemetry import get_telemetry

__all__ = ["PSOGAConfig", "PSOGAResult", "SwarmDraws", "run_pso_ga",
           "init_swarm", "swarm_step", "draw_swarm", "draws_from_uniforms",
           "state_from_arrays"]


@dataclasses.dataclass(frozen=True)
class PSOGAConfig:
    pop_size: int = 100
    max_iters: int = 1000
    stall_iters: int = 50           # paper §V-C: stop after 50 unchanged
    w_max: float = 0.9
    w_min: float = 0.4
    c1_start: float = 0.9
    c1_end: float = 0.2
    c2_start: float = 0.4
    c2_end: float = 0.9
    faithful_sim: bool = False      # False = parent-gated recurrence (the
    #   paper's Fig. 2 numbers); True = Alg. 2 line 21 verbatim
    bias_init_to_tiers: bool = True  # seed swarm with tier-aware particles
    # incumbent ("warm") seeding of online re-planning; only consulted when
    # init_swarm gets an incumbent
    warm_elite: int = 2             # exact clones of the incumbent plan
    warm_fraction: float = 0.5      # swarm share seeded in the incumbent's
    #   neighborhood (per-gene redraw with prob warm_mutation)
    warm_mutation: float = 0.1      # per-gene neighborhood redraw prob
    miss_budget: float = 0.05       # p95 deadline-miss budget of the
    #   traffic key (used only when a solve is given arrivals)


class PSOGAResult(NamedTuple):
    best_x: np.ndarray           # (p,) best server assignment found
    best_fitness: float          # scalar key (cost if feasible)
    best_cost: float             # C_total of best (inf if infeasible)
    feasible: bool
    iterations: int              # iterations actually executed
    history: Optional[np.ndarray] = None  # (max_iters,) gBest key per iter


class _SwarmState(NamedTuple):
    """The swarm; every field may carry a leading fleet axis."""
    X: torch.Tensor              # (P, max_p) int32
    pbest_x: torch.Tensor        # (P, max_p) int32
    pbest_f: torch.Tensor        # (P,) f32
    gbest_x: torch.Tensor        # (max_p,) int32
    gbest_f: torch.Tensor        # () f32
    it: torch.Tensor             # () int32
    stall: torch.Tensor          # () int32


class SwarmDraws(NamedTuple):
    """The random numbers of one PSO-GA step (``pso_ga.py:225-257`` of the
    reference), each with an optional leading fleet axis:

      * ``do_mu (P,)`` uniform in [0, 1): mutate where ``do_mu < w``;
      * ``pos (P,)`` / ``val (P,)`` int32 mutation gene and server, in
        ``[0, p)`` and ``[0, S)`` of the problem's TRUE sizes;
      * ``c1 (P,)`` uniform: crossover with pBest where ``c1 < c1(t)``;
      * ``seg1 (P, 2)`` int32 segment ends in ``[0, p)``;
      * ``c2 (P,)`` / ``seg2 (P, 2)`` likewise for the gBest crossover.
    """
    do_mu: torch.Tensor
    pos: torch.Tensor
    val: torch.Tensor
    c1: torch.Tensor
    seg1: torch.Tensor
    c2: torch.Tensor
    seg2: torch.Tensor


#: uniform columns per particle per step: do_mu, pos, val, c1, seg1 x2,
#: c2, seg2 x2
_N_UNIFORMS = 9


def draws_from_uniforms(u: torch.Tensor, num_layers: torch.Tensor,
                        num_servers: torch.Tensor) -> SwarmDraws:
    """``SwarmDraws`` from ``u (..., P, 9)`` uniforms: integer draws are
    ``floor(u * bound)`` against each problem's true ``p`` / ``S``."""
    p = num_layers.to(torch.int32)[..., None]
    s = num_servers.to(torch.int32)[..., None]

    def below(col: int, bound: torch.Tensor) -> torch.Tensor:
        k = (u[..., col] * bound.to(u.dtype)).floor().to(torch.int32)
        return torch.minimum(k, bound - 1)        # u*bound may round up

    return SwarmDraws(
        do_mu=u[..., 0], pos=below(1, p), val=below(2, s), c1=u[..., 3],
        seg1=torch.stack([below(4, p), below(5, p)], -1), c2=u[..., 6],
        seg2=torch.stack([below(7, p), below(8, p)], -1))


def draw_swarm(pp: PaddedProblem, pop_size: int,
               generators: Sequence[torch.Generator]) -> SwarmDraws:
    """One step's draws: one generator per problem (one for a single
    problem, N for a stacked fleet), so every problem's stream is the one
    it would draw when solved alone."""
    u = torch.stack([torch.rand((pop_size, _N_UNIFORMS), generator=g,
                                device=pp.device) for g in generators])
    if not pp.stacked:
        u = u[0]
    return draws_from_uniforms(u, pp.num_layers, pp.num_servers)


def state_from_arrays(src, device: Optional[Union[str, torch.device]] = None
                      ) -> _SwarmState:
    """A swarm state from any object with the fields of ``_SwarmState``
    whose values numpy can read (e.g. the reference's ``_SwarmState``;
    its PRNG ``key`` is not carried over)."""
    dev = resolve_device(device)
    conv = {"pbest_f": np.float32, "gbest_f": np.float32}
    return _SwarmState(**{
        name: torch.as_tensor(
            np.asarray(getattr(src, name)).astype(conv.get(name, np.int32)),
            device=dev)
        for name in _SwarmState._fields})


def _clamp_pins(X: torch.Tensor, pinned: torch.Tensor) -> torch.Tensor:
    pinned = pinned[..., None, :]
    return torch.where(pinned >= 0, pinned, X)


def _home_servers(prob: SimProblem) -> np.ndarray:
    """Per-layer home server: the pinned server of the layer's app (or 0)."""
    pin_per_app = {}
    pinned_np = np.asarray(prob.pinned)
    app_np = np.asarray(prob.app_id)
    for j in range(prob.num_layers):
        if pinned_np[j] >= 0:
            pin_per_app.setdefault(int(app_np[j]), int(pinned_np[j]))
    return np.array([pin_per_app.get(int(a), 0) for a in app_np], np.int32)


def init_swarm(prob: SimProblem, cfg: PSOGAConfig,
               generator: torch.Generator,
               device: Optional[Union[str, torch.device]] = None,
               incumbent: Optional[np.ndarray] = None,
               rescue: bool = False) -> torch.Tensor:
    """Link-aware random initialization, ``(pop_size, p)`` int32 on
    ``device``.

    Genes are drawn uniformly over the servers reachable from the app's
    home device ({home} ∪ {s : ℓ(home, s) > 0}), so the initial swarm has
    no forbidden-link placement; mutation still draws from ALL servers.
    With ``cfg.bias_init_to_tiers`` particle 0 is the everything-stays-home
    placement and the next ones the single-server placements (≤ S+1
    anchors in all).

    With ``incumbent`` (a ``(p,)`` plan, online re-planning) the swarm is
    seeded around it instead: ``cfg.warm_elite`` exact clones, then
    ``cfg.warm_fraction`` of the swarm in its neighborhood (each gene
    redrawn with prob ``cfg.warm_mutation`` over the layer's reachable
    servers), then the cold random draw. ``rescue`` (set where drift left
    the incumbent infeasible) puts the all-home placement and the
    single-server placements by DESCENDING power at the tail, so the
    strongest escape hatches survive truncation. The warm draws follow the
    cold one on ``generator``, so ``incumbent=None`` draws exactly the cold
    swarm. Pins are applied last.
    """
    dev = resolve_device(device)
    p, s, P = prob.num_layers, prob.num_servers, cfg.pop_size
    home = _home_servers(prob)
    allowed = np.asarray(prob.link_ok)[home, :].copy()          # (p, S)
    allowed[np.arange(p), home] = True
    counts = torch.as_tensor(allowed.sum(1), device=dev)        # (p,)
    # row j lists layer j's allowed servers first, in ascending order
    table = torch.as_tensor(np.argsort(~allowed, axis=1, kind="stable"),
                            device=dev)
    rows = torch.arange(p, device=dev)[None, :]

    def reachable(n: int) -> torch.Tensor:
        u = torch.rand((n, p), generator=generator, device=dev)
        k = torch.minimum((u * counts).floor().long(), counts - 1)
        return table[rows, k].to(torch.int32)

    X = reachable(P)
    home_t = torch.as_tensor(home, device=dev)
    if incumbent is not None:
        inc = torch.as_tensor(np.asarray(incumbent), dtype=torch.int32,
                              device=dev)
        n_elite = max(1, min(cfg.warm_elite, P))
        n_neigh = min(int(round(cfg.warm_fraction * P)), P - n_elite)
        X[:n_elite] = inc
        if n_neigh > 0:
            mut = torch.rand((n_neigh, p), generator=generator,
                             device=dev) < cfg.warm_mutation
            X[n_elite:n_elite + n_neigh] = torch.where(
                mut, reachable(n_neigh), inc)
        tail = n_elite + n_neigh
        if rescue and cfg.bias_init_to_tiers and tail < P:
            n_anchor = min(s + 1, P - tail)
            X[tail] = home_t
            by_power = np.argsort(-np.asarray(prob.power), kind="stable")
            for a in range(n_anchor - 1):
                X[tail + 1 + a] = int(by_power[a])
    elif cfg.bias_init_to_tiers:
        n_anchor = min(s + 1, P - 1)
        X[0] = home_t
        for a in range(n_anchor - 1):
            X[1 + a] = a
    return _clamp_pins(X, torch.as_tensor(prob.pinned, device=dev))


def swarm_step(pp: PaddedProblem, state: _SwarmState, cfg: PSOGAConfig,
               draws: Optional[SwarmDraws] = None,
               generators: Optional[Sequence[torch.Generator]] = None,
               arrivals=None, incumbent: Optional[torch.Tensor] = None,
               mig_weight=None,
               inertia: Optional[torch.Tensor] = None) -> _SwarmState:
    """One PSO-GA iteration on the padded representation (Eq. 17–23).

    Works on one problem or on a stacked fleet (a leading axis on ``pp``,
    ``state`` and ``draws``). ``draws`` default to ``draw_swarm(pp, ...,
    generators)``. Mutation and crossover positions lie in each problem's
    true ``p`` and mutation values in its true ``S``, so padded genes are
    never touched and padded servers never proposed.

    ``arrivals`` (``(M, max_apps, R)``, or ``(N, M, max_apps, R)``
    stacked) switch the fitness to the traffic key under
    ``cfg.miss_budget``. A solve loop passes them as ``TrafficInputs``,
    built once by ``traffic_inputs``, so no step rebuilds the merged order.

    ``incumbent`` (``(max_p,)``, or ``(N, max_p)`` stacked) and
    ``mig_weight`` (scalar or ``(N,)``) switch the fitness to the
    migration-aware warm key; a weight of 0 gives the cold key bit for
    bit. ``inertia`` (``()``, or ``(N,)`` stacked) replaces Eq. 22–23's
    per-particle weight with one ``w`` for the whole swarm (the linear
    schedule of Eq. 21).
    """
    max_p = pp.pinned.shape[-1]
    if draws is None:
        draws = draw_swarm(pp, cfg.pop_size, generators)
    fit = make_swarm_fitness(pp, cfg.faithful_sim, incumbent=incumbent,
                             mig_weight=mig_weight, arrivals=arrivals,
                             miss_budget=cfg.miss_budget)
    t = state.it.to(torch.float32) / cfg.max_iters
    c1 = cfg.c1_start + (cfg.c1_end - cfg.c1_start) * t
    c2 = cfg.c2_start + (cfg.c2_end - cfg.c2_start) * t

    if inertia is not None:
        w = inertia[..., None]
    else:
        # adaptive inertia (Eq. 22-23): padded genes never differ from
        # gBest's, so the count covers real genes only; divide by the TRUE
        # gene count
        d = (state.X != state.gbest_x[..., None, :]).to(torch.float32) \
            .sum(-1) / pp.num_layers.to(torch.float32)[..., None]
        w = cfg.w_max - (cfg.w_max - cfg.w_min) * torch.exp(d / (d - 1.01))

    genes = torch.arange(max_p, device=pp.device)
    do_mu = draws.do_mu < w                                    # Eq. 20
    A = torch.where((genes == draws.pos[..., None]) & do_mu[..., None],
                    draws.val[..., None], state.X)

    def segment(seg: torch.Tensor) -> torch.Tensor:
        lo = seg.amin(-1, keepdim=True)
        hi = seg.amax(-1, keepdim=True)
        return (genes >= lo) & (genes <= hi)

    do_c1 = draws.c1 < c1[..., None]                           # Eq. 18
    B = torch.where(segment(draws.seg1) & do_c1[..., None], state.pbest_x, A)
    do_c2 = draws.c2 < c2[..., None]                           # Eq. 19
    C = torch.where(segment(draws.seg2) & do_c2[..., None],
                    state.gbest_x[..., None, :], B)

    X = _clamp_pins(C, pp.pinned).to(torch.int32)
    f = fit(X)
    improved = f < state.pbest_f
    pbest_x = torch.where(improved[..., None], X, state.pbest_x)
    pbest_f = torch.where(improved, f, state.pbest_f)
    i_best = pbest_f.argmin(-1, keepdim=True)                  # first min
    cand_f = pbest_f.gather(-1, i_best)[..., 0]
    cand_x = pbest_x.gather(
        -2, i_best[..., None].expand(*i_best.shape[:-1], 1, max_p))[..., 0, :]
    better = cand_f < state.gbest_f
    return _SwarmState(
        X=X, pbest_x=pbest_x, pbest_f=pbest_f,
        gbest_x=torch.where(better[..., None], cand_x, state.gbest_x),
        gbest_f=torch.where(better, cand_f, state.gbest_f),
        it=state.it + 1,
        stall=torch.where(better, torch.zeros_like(state.stall),
                          state.stall + 1))


#: ``draw_fn(problem_index, step) -> SwarmDraws`` of (P,) arrays
DrawFn = Callable[[int, int], SwarmDraws]


def run_pso_ga(dag: LayerDAG, env: Environment,
               cfg: PSOGAConfig = PSOGAConfig(),
               seed: int = 0,
               record_history: bool = False,
               device: Optional[Union[str, torch.device]] = None,
               X0: Optional[np.ndarray] = None,
               draw_fn: Optional[DrawFn] = None,
               arrivals: Optional[np.ndarray] = None,
               telemetry=None) -> PSOGAResult:
    """Run PSO-GA to convergence on ``device`` (``None`` = the card).

    ``X0`` replaces the initial swarm and ``draw_fn(0, step)`` each step's
    draws; by default both come from a ``torch.Generator`` seeded with
    ``seed``. With ``record_history`` the solve runs all ``max_iters``
    iterations and returns the gBest key after each. The problem is
    padded to its own sizes only, as the reference pads it.

    ``arrivals`` (``(M, n_apps, R)`` Monte-Carlo request times,
    DESIGN.md §10) switch the fitness to the queue-aware traffic key:
    ``best_fitness`` is then the traffic key, while ``best_cost`` and
    ``feasible`` still report the zero-load replay of the winning plan
    (so a plan can be ``feasible`` with a key above the offset); use
    ``traffic.traffic_replay`` for the plan's load metrics.

    With ``record_history`` and a telemetry channel (explicit arg, or the
    process-global one from ``telemetry_scope``) the per-iteration gBest
    curve is published as the ``solver.gbest`` metric series (DESIGN.md
    §13) beside the returned ``history``; as in the reference, a single
    solve opens no ``fleet_solve`` span.
    """
    from .batch import _solve_fleet
    res = _solve_fleet(
        [(dag, env)], cfg, seed, False, device,
        None if X0 is None else [X0], draw_fn, record_history,
        None if arrivals is None else [arrivals])[0]
    if record_history:
        tel = telemetry if telemetry is not None else get_telemetry()
        if tel is not None:
            tel.record_series("solver.gbest", res.history)
            tel.inc("solver.history_runs")
    return res


def stack_draws(draws: List[SwarmDraws],
                device: torch.device) -> SwarmDraws:
    """Stack per-problem draws (tensors or anything numpy reads) along a
    fleet axis, as float32 uniforms and int32 indices."""
    def conv(v, dtype):
        t = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        return t.to(device=device, dtype=dtype)

    return SwarmDraws(*(
        torch.stack([conv(v, torch.float32 if name in ("do_mu", "c1", "c2")
                          else torch.int32) for v in field])
        for name, field in zip(SwarmDraws._fields, zip(*draws))))
