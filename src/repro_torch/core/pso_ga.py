"""PSO-GA — self-adaptive discrete PSO with GA operators (paper §IV-B),
ported from ``repro.core.pso_ga`` (cold solves, no traffic).

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
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.Tensor:
    """Link-aware random initialization (cold mode), ``(pop_size, p)``
    int32 on ``device``.

    Genes are drawn uniformly over the servers reachable from the app's
    home device ({home} ∪ {s : ℓ(home, s) > 0}), so the initial swarm has
    no forbidden-link placement; mutation still draws from ALL servers.
    With ``cfg.bias_init_to_tiers`` particle 0 is the everything-stays-home
    placement and the next ones the single-server placements (≤ S+1
    anchors in all). Pins are applied last.
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
    u = torch.rand((P, p), generator=generator, device=dev)
    k = torch.minimum((u * counts).floor().long(), counts - 1)
    X = table[torch.arange(p, device=dev)[None, :], k].to(torch.int32)
    if cfg.bias_init_to_tiers:
        n_anchor = min(s + 1, P - 1)
        X[0] = torch.as_tensor(home, device=dev)
        for a in range(n_anchor - 1):
            X[1 + a] = a
    return _clamp_pins(X, torch.as_tensor(prob.pinned, device=dev))


def swarm_step(pp: PaddedProblem, state: _SwarmState, cfg: PSOGAConfig,
               draws: Optional[SwarmDraws] = None,
               generators: Optional[Sequence[torch.Generator]] = None
               ) -> _SwarmState:
    """One PSO-GA iteration on the padded representation (Eq. 17–23).

    Works on one problem or on a stacked fleet (a leading axis on ``pp``,
    ``state`` and ``draws``). ``draws`` default to ``draw_swarm(pp, ...,
    generators)``. Mutation and crossover positions lie in each problem's
    true ``p`` and mutation values in its true ``S``, so padded genes are
    never touched and padded servers never proposed.
    """
    max_p = pp.pinned.shape[-1]
    if draws is None:
        draws = draw_swarm(pp, cfg.pop_size, generators)
    fit = make_swarm_fitness(pp, cfg.faithful_sim)
    t = state.it.to(torch.float32) / cfg.max_iters
    c1 = cfg.c1_start + (cfg.c1_end - cfg.c1_start) * t
    c2 = cfg.c2_start + (cfg.c2_end - cfg.c2_start) * t

    # adaptive inertia (Eq. 22-23): padded genes never differ from gBest's,
    # so the count covers real genes only; divide by the TRUE gene count
    d = (state.X != state.gbest_x[..., None, :]).to(torch.float32).sum(-1) \
        / pp.num_layers.to(torch.float32)[..., None]
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
               draw_fn: Optional[DrawFn] = None) -> PSOGAResult:
    """Run PSO-GA to convergence on ``device`` (``None`` = the card).

    ``X0`` replaces the initial swarm and ``draw_fn(0, step)`` each step's
    draws; by default both come from a ``torch.Generator`` seeded with
    ``seed``. With ``record_history`` the solve runs all ``max_iters``
    iterations and returns the gBest key after each. The problem is
    padded to its own sizes only, as the reference pads it.
    """
    from .batch import run_pso_ga_batch
    return run_pso_ga_batch(
        [(dag, env)], cfg, seed=seed, bucket=False, device=device,
        X0=None if X0 is None else [X0], draw_fn=draw_fn,
        record_history=record_history)[0]


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
