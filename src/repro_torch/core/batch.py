"""Fleet-scale batched PSO-GA: solve N heterogeneous offloading problems
with one fleet of swarms per shape bucket, ported from
``repro.core.batch``: cold and warm (incumbent-seeded, migration-aware)
solves, with or without traffic, on one device (no mesh).

``pack_fleet`` groups problems into power-of-two ``(max_p, max_S)``
buckets and stacks each bucket's members into one ``PaddedProblem`` with
a leading fleet axis; the replay kernel takes that axis as its second
grid dimension, so one launch scores every particle of every problem in
the bucket.

The iteration loop is a Python loop with per-problem freezing: a problem
whose stall counter reaches ``cfg.stall_iters`` (or whose ``it`` reaches
``cfg.max_iters``) passes through unchanged while the rest keep
iterating. A frozen problem never changes again, so the loop checks the
stop rule on the host only every ``SYNC_EVERY`` iterations; the extra
steps change no result, and ``it`` stays exact. Every problem draws from
its own generator seeded like ``run_pso_ga``, within its own true sizes,
so a batched solve equals the sequential solves gene for gene. Under
traffic each problem's arrival draws route with it by original index;
padded apps never receive a request and padded layers are never walked,
so that equality holds for traffic solves too. Incumbents, migration
weights and rescue flags route by original index the same way.

Public surface: ``run_pso_ga_batch`` (``incumbent=``,
``migration_weight=``, ``warm_rescue=``, ``return_state=``,
``telemetry=``),
``pack_fleet`` / ``PackedFleet`` / ``FleetBucket``, ``pack_problems``,
``pack_arrivals``, ``bucket_size`` and ``SYNC_EVERY``.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..kernels.schedule_sim import schedule_replay
from .dag import LayerDAG
from .device import resolve_device
from .environment import Environment
from .fitness import make_swarm_fitness
from .pso_ga import (DrawFn, PSOGAConfig, PSOGAResult, SwarmDraws,
                     _SwarmState, init_swarm, stack_draws, swarm_step)
from .seeding import coerce_seed
from .simulator import (PaddedProblem, SimProblem, kernel_args, pad_problem,
                        stack_problems)
from .telemetry import Telemetry, get_telemetry, maybe_span
from .traffic import traffic_inputs

__all__ = ["pack_problems", "pack_arrivals", "run_pso_ga_batch",
           "bucket_size", "FleetBucket", "PackedFleet", "pack_fleet",
           "SYNC_EVERY"]

ProblemLike = Union[SimProblem, Tuple[LayerDAG, Environment]]

#: iterations between host checks of the fleet's stop rule
SYNC_EVERY = 8


def bucket_size(n: int, floor: int = 8) -> int:
    """Round up to the next power of two (>= floor) — the shape bucket."""
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def _as_problems(problems: Sequence[ProblemLike]) -> List[SimProblem]:
    out = []
    for pr in problems:
        if isinstance(pr, SimProblem):
            out.append(pr)
        else:
            dag, env = pr
            out.append(SimProblem.build(dag, env))
    return out


def _normalize_seeds(seed, n: int) -> List[int]:
    """One seed per problem from any int-like scalar or 1-d sequence."""
    arr = np.asarray(seed)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"seed must be int-like, got dtype {arr.dtype}")
    if arr.ndim == 0:
        return [coerce_seed(arr)] * n
    if arr.ndim != 1:
        raise ValueError(f"seed must be a scalar or 1-d sequence, "
                         f"got shape {arr.shape}")
    if arr.shape[0] != n:
        raise ValueError(f"{arr.shape[0]} seeds for {n} problems")
    return [int(s) for s in arr]


def pack_problems(problems: Sequence[ProblemLike], bucket: bool = True,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> PaddedProblem:
    """Pack N problems into one stacked ``PaddedProblem`` at a single
    fleet-global shape (power-of-two layer/server axes with ``bucket``)."""
    probs = _as_problems(problems)
    if not probs:
        raise ValueError("pack_problems needs at least one problem")
    max_p = max(pr.num_layers for pr in probs)
    max_S = max(pr.num_servers for pr in probs)
    if bucket:
        max_p, max_S = bucket_size(max_p), bucket_size(max_S, floor=4)
    max_in = max(pr.parent_idx.shape[1] for pr in probs)
    max_out = max(pr.child_idx.shape[1] for pr in probs)
    max_apps = max(pr.num_apps for pr in probs)
    return stack_problems([
        pad_problem(pr, max_p=max_p, max_S=max_S, max_in=max_in,
                    max_out=max_out, max_apps=max_apps, device=device)
        for pr in probs])


class FleetBucket(NamedTuple):
    """One shape bucket of a ``PackedFleet``: the members stacked at the
    bucket's padded shape, plus their original fleet indices."""
    ppb: PaddedProblem           # stacked fields, leading axis = len(idx)
    idx: np.ndarray              # (len,) original problem indices
    max_p: int                   # bucket layer padding (power of two)
    max_S: int                   # bucket server padding (power of two)


@dataclasses.dataclass(frozen=True)
class PackedFleet:
    """N problems grouped into ``(max_p, max_S)`` shape buckets. Bucket
    membership depends only on each problem's own sizes; ``idx`` restores
    input order."""
    buckets: Tuple[FleetBucket, ...]
    n_problems: int
    max_apps: int


def pack_fleet(problems: Sequence[ProblemLike], bucket: bool = True,
               device: Optional[Union[str, torch.device]] = None
               ) -> PackedFleet:
    """Group N problems into power-of-two ``(max_p, max_S)`` buckets of
    their OWN sizes (``bucket=False``: one bucket at the exact global
    max). In/out-degree and app paddings stay fleet-global."""
    dev = resolve_device(device)
    probs = _as_problems(problems)
    if not probs:
        raise ValueError("pack_fleet needs at least one problem")
    max_in = max(pr.parent_idx.shape[1] for pr in probs)
    max_out = max(pr.child_idx.shape[1] for pr in probs)
    max_apps = max(pr.num_apps for pr in probs)
    if bucket:
        def key(pr: SimProblem) -> Tuple[int, int]:
            return (bucket_size(pr.num_layers),
                    bucket_size(pr.num_servers, floor=4))
    else:
        gp = max(pr.num_layers for pr in probs)
        gS = max(pr.num_servers for pr in probs)

        def key(pr: SimProblem) -> Tuple[int, int]:
            return (gp, gS)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, pr in enumerate(probs):
        groups.setdefault(key(pr), []).append(i)
    buckets = []
    for bp, bS in sorted(groups):
        idx = np.asarray(groups[(bp, bS)], np.int64)
        ppb = stack_problems([
            pad_problem(probs[i], max_p=bp, max_S=bS, max_in=max_in,
                        max_out=max_out, max_apps=max_apps, device=dev)
            for i in idx])
        buckets.append(FleetBucket(ppb=ppb, idx=idx, max_p=bp, max_S=bS))
    return PackedFleet(buckets=tuple(buckets), n_problems=len(probs),
                       max_apps=max_apps)


def pack_arrivals(arrivals: Sequence[np.ndarray],
                  max_apps: int) -> np.ndarray:
    """Stack per-problem ``(M, n_apps_i, R)`` Monte-Carlo arrival arrays
    into one ``(N, M, max_apps, R)`` array, padding the app axis with +inf
    (a padded app never receives a request). Every problem must share the
    seed count M and the request cap R; NaN or negative times are corrupt
    draws and are rejected."""
    mats = [np.asarray(a, float) for a in arrivals]
    if not mats:
        raise ValueError("pack_arrivals needs at least one arrival set")
    for i, a in enumerate(mats):
        if a.ndim != 3:
            raise ValueError(
                f"arrivals[{i}] has shape {a.shape}; expected a 3-d "
                f"(M, n_apps, R) Monte-Carlo array")
    m0, r0 = mats[0].shape[0], mats[0].shape[2]
    for i, a in enumerate(mats):
        if a.shape[0] != m0 or a.shape[2] != r0:
            raise ValueError(
                f"arrivals[{i}] has shape {a.shape}; expected (M={m0}, "
                f"n_apps, R={r0}) with M and R shared across the fleet")
        if a.shape[1] > max_apps:
            raise ValueError(f"arrivals[{i}] has {a.shape[1]} apps > "
                             f"packed max_apps {max_apps}")
        if np.isnan(a).any() or (a < 0.0).any():
            raise ValueError(f"arrivals[{i}] contains NaN or negative "
                             f"request times")
    out = np.full((len(mats), m0, max_apps, r0), np.inf)
    for i, a in enumerate(mats):
        out[i, :, :a.shape[1], :] = a
    return out


def _done(state: _SwarmState, cfg: PSOGAConfig) -> torch.Tensor:
    """(N,) bool — which problems have hit the paper's stopping rule."""
    return (state.it >= cfg.max_iters) | (state.stall >= cfg.stall_iters)


def _run_fleet(ppb: PaddedProblem, X0: torch.Tensor, cfg: PSOGAConfig,
               draw: Optional[Callable[[int], SwarmDraws]],
               generators: Sequence[torch.Generator],
               record_history: bool = False,
               arrivals: Optional[np.ndarray] = None,
               incumbent: Optional[torch.Tensor] = None,
               mig_weight: Optional[torch.Tensor] = None,
               linear_inertia: bool = False
               ) -> Tuple[_SwarmState, Optional[torch.Tensor]]:
    """Iterate a stacked fleet of swarms to convergence.

    ``X0 (N, P, max_p)``; ``draw(step)`` gives the step's ``(N, P)``
    draws, else each problem draws from its own generator. ``arrivals
    (N, M, max_apps, R)`` switch every problem to the traffic key; their
    merged orders are built once for the whole solve. ``incumbent (N,
    max_p)`` and ``mig_weight (N,)`` add the migration term to every
    score, the initial one included. ``linear_inertia`` replaces Eq.
    22–23 with Eq. 21's ``w_max − (w_max − w_min)·it/max_iters``. Returns
    the final state and, with ``record_history`` (which runs exactly
    ``max_iters`` steps without freezing, as the reference's history mode
    does), the ``(N, max_iters)`` gBest keys.
    """
    max_p = X0.shape[-1]
    tin = None if arrivals is None else traffic_inputs(ppb, arrivals)
    f0 = make_swarm_fitness(ppb, cfg.faithful_sim, incumbent=incumbent,
                            mig_weight=mig_weight, arrivals=tin,
                            miss_budget=cfg.miss_budget)(X0)  # (N, P)
    i0 = f0.argmin(-1, keepdim=True)
    zeros = torch.zeros(X0.shape[0], dtype=torch.int32, device=X0.device)
    state = _SwarmState(
        X=X0, pbest_x=X0, pbest_f=f0,
        gbest_x=X0.gather(1, i0[..., None].expand(-1, 1, max_p))[:, 0],
        gbest_f=f0.gather(1, i0)[:, 0], it=zeros, stall=zeros)
    history = []
    for step in range(cfg.max_iters):
        if not record_history and step % SYNC_EVERY == 0 \
                and bool(_done(state, cfg).all()):
            break
        w = None
        if linear_inertia:                                     # Eq. 21
            t = state.it.to(torch.float32) / cfg.max_iters
            w = cfg.w_max - (cfg.w_max - cfg.w_min) * t
        new = swarm_step(ppb, state, cfg,
                         draws=None if draw is None else draw(step),
                         generators=generators, arrivals=tin,
                         incumbent=incumbent, mig_weight=mig_weight,
                         inertia=w)
        if record_history:
            state = new
            history.append(state.gbest_f)
            continue
        frozen = _done(state, cfg)
        state = _SwarmState(*(
            torch.where(frozen.view((-1,) + (1,) * (nw.dim() - 1)), old, nw)
            for nw, old in zip(new, state)))
    return state, (torch.stack(history, 1) if history else None)


def run_pso_ga_batch(problems: Sequence[ProblemLike],
                     cfg: PSOGAConfig = PSOGAConfig(),
                     seed: Union[int, Sequence[int]] = 0,
                     bucket: bool = True,
                     device: Optional[Union[str, torch.device]] = None,
                     X0: Optional[Sequence[np.ndarray]] = None,
                     draw_fn: Optional[DrawFn] = None,
                     record_history: bool = False,
                     arrivals: Optional[Sequence[np.ndarray]] = None,
                     incumbent: Optional[Sequence[
                         Optional[np.ndarray]]] = None,
                     migration_weight: Union[float, Sequence[float]] = 0.0,
                     warm_rescue: Optional[Sequence[bool]] = None,
                     return_state: bool = False,
                     telemetry: Optional[Telemetry] = None):
    """Solve N offloading problems with one fleet of swarms per bucket,
    on ``device`` (``None`` = the card).

    ``seed`` is one seed for every problem or one per problem: problem i
    behaves exactly like ``run_pso_ga(..., seed=seed_i)``. ``X0`` (one
    ``(pop_size, p_i)`` swarm per problem) and ``draw_fn(i, step)``
    replace the generator's initial swarms and step draws, indexed by
    ORIGINAL problem index. ``arrivals`` (one ``(M, n_apps_i, R)`` array
    per problem, routed by original index) switch every problem to the
    traffic key under ``cfg.miss_budget``.

    ``incumbent`` (one ``(p_i,)`` plan per problem, online re-planning)
    warm-starts each swarm around its incumbent (``init_swarm``'s
    incumbent mode, and its rescue mode where ``warm_rescue[i]``) and adds
    ``migration_weight`` (scalar or one per problem) × the Eq. 6-form cost
    of every moved layer to the key. A ``None`` entry solves that problem
    cold, with weight 0, inside the warm fleet.

    Each bucket's epilogue scores its gBests as a one-row swarm through
    the zero-load replay, so ``best_cost`` and ``feasible`` are the
    zero-load plan's and ``best_fitness`` the key the solve minimised.
    Returns per-problem ``PSOGAResult`` in input order and, with
    ``return_state``, the final ``_SwarmState`` in input order at the
    largest bucket's ``max_p`` (genes beyond a problem's own bucket are 0).

    ``telemetry`` (DESIGN.md §13; ``None`` falls back to the process-global
    channel) wraps each bucket's solve in a ``fleet_solve`` span that ends
    once the bucket's results are on the host, so it spans the device
    work and adds no sync; results are bit-identical with it on or off.
    The reference's ``runner_cache.*`` metrics have no counterpart: the
    port compiles nothing per shape.
    """
    tel = telemetry if telemetry is not None else get_telemetry()
    return _solve_fleet(problems, cfg, seed, bucket, device, X0, draw_fn,
                        record_history, arrivals, incumbent,
                        migration_weight, warm_rescue, return_state,
                        tel=tel)


def _solve_fleet(problems, cfg, seed, bucket, device, X0, draw_fn,
                 record_history, arrivals, incumbent=None,
                 migration_weight=0.0, warm_rescue=None,
                 return_state=False, linear_inertia=False, tel=None):
    """``run_pso_ga_batch``'s body; ``linear_inertia`` serves
    ``baselines.run_pso_linear``; ``tel`` gets one ``fleet_solve`` span
    per bucket."""
    dev = resolve_device(device)
    probs = _as_problems(problems)
    n = len(probs)
    seeds = _normalize_seeds(seed, n)
    if X0 is not None and len(X0) != n:
        raise ValueError(f"{len(X0)} initial swarms for {n} problems")
    if arrivals is not None and len(arrivals) != n:
        raise ValueError(f"{len(arrivals)} arrival sets for {n} problems")
    if incumbent is not None and len(incumbent) != n:
        raise ValueError(f"{len(incumbent)} incumbents for {n} problems")
    mig_arr = np.broadcast_to(np.asarray(migration_weight, np.float32), (n,))
    fleet = pack_fleet(probs, bucket=bucket, device=dev)
    results: List[Optional[PSOGAResult]] = [None] * n
    states = []
    for b in fleet.buckets:
        nb = len(b.idx)
        gens = []
        X0b = torch.zeros((nb, cfg.pop_size, b.max_p), dtype=torch.int32,
                          device=dev)
        incb = torch.zeros((nb, b.max_p), dtype=torch.int32, device=dev)
        migb = torch.zeros((nb,), dtype=torch.float32, device=dev)
        for j, i in enumerate(b.idx):
            g = torch.Generator(device=dev)
            g.manual_seed(seeds[i])
            gens.append(g)
            pr = probs[i]
            inc_i, rescue_i = None, False
            if incumbent is not None and incumbent[i] is not None:
                inc_i = np.asarray(incumbent[i], np.int32)
                if inc_i.shape != (pr.num_layers,):
                    raise ValueError(
                        f"incumbent[{i}] has shape {inc_i.shape}, "
                        f"expected ({pr.num_layers},)")
                incb[j, :pr.num_layers] = torch.as_tensor(inc_i)
                migb[j] = float(mig_arr[i])
                rescue_i = warm_rescue is not None and bool(warm_rescue[i])
            x0 = init_swarm(pr, cfg, g, dev, incumbent=inc_i,
                            rescue=rescue_i) if X0 is None else \
                torch.tensor(np.asarray(X0[i]), dtype=torch.int32,
                             device=dev)
            if tuple(x0.shape) != (cfg.pop_size, pr.num_layers):
                raise ValueError(f"initial swarm {i} has shape "
                                 f"{tuple(x0.shape)}, expected "
                                 f"{(cfg.pop_size, pr.num_layers)}")
            X0b[j, :, :pr.num_layers] = x0
        draw = None
        if draw_fn is not None:
            def draw(step, idx=b.idx):
                return stack_draws([draw_fn(int(i), step) for i in idx], dev)

        arrb = None if arrivals is None else pack_arrivals(
            [arrivals[i] for i in b.idx], fleet.max_apps)
        warm = incumbent is not None
        # the span closes once the bucket's results are on the host
        with maybe_span(tel, "fleet_solve", bucket=f"{b.max_p}x{b.max_S}",
                        n=nb, traffic=arrivals is not None, sharded=False):
            state, history = _run_fleet(
                b.ppb, X0b, cfg, draw, gens, record_history, arrb,
                incumbent=incb if warm else None,
                mig_weight=migb if warm else None,
                linear_inertia=linear_inertia)
            total, feas, _ = schedule_replay(
                *kernel_args(b.ppb), state.gbest_x[:, None, :].contiguous(),
                faithful=cfg.faithful_sim)
            total = total[:, 0].cpu().numpy()
            feas = feas[:, 0].cpu().numpy()
            gbest_x = state.gbest_x.cpu().numpy()
            gbest_f = state.gbest_f.cpu().numpy()
            its = state.it.cpu().numpy()
        for j, i in enumerate(b.idx):
            ok = bool(feas[j])
            results[i] = PSOGAResult(
                best_x=gbest_x[j, :probs[i].num_layers],
                best_fitness=float(gbest_f[j]),
                best_cost=float(total[j]) if ok else float("inf"),
                feasible=ok, iterations=int(its[j]),
                history=None if history is None
                else history[j].cpu().numpy())
        states.append((b, state))
    if not return_state:
        return results
    return results, _fleet_state(states, n, cfg.pop_size, dev)


def _fleet_state(states, n: int, P: int, dev: torch.device) -> _SwarmState:
    """One input-ordered state from the buckets' states, at the largest
    bucket's ``max_p``; genes beyond a problem's own bucket are 0."""
    gmax_p = max(b.max_p for b, _ in states)
    shapes = {"X": (n, P, gmax_p), "pbest_x": (n, P, gmax_p),
              "pbest_f": (n, P), "gbest_x": (n, gmax_p), "gbest_f": (n,),
              "it": (n,), "stall": (n,)}
    out = {name: torch.zeros(shape, dtype=getattr(states[0][1], name).dtype,
                             device=dev) for name, shape in shapes.items()}
    for b, st in states:
        idx = torch.as_tensor(b.idx, device=dev)
        for name in shapes:
            v = getattr(st, name)
            if name in ("X", "pbest_x", "gbest_x"):
                out[name][idx, ..., :b.max_p] = v
            else:
                out[name][idx] = v
    return _SwarmState(**out)
