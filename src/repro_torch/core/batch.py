"""Fleet-scale batched PSO-GA: solve N heterogeneous offloading problems
with one fleet of swarms per shape bucket, ported from
``repro.core.batch`` (cold solves; no mesh, traffic or incumbents).

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
so a batched solve equals the sequential solves gene for gene.
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

__all__ = ["pack_problems", "run_pso_ga_batch", "bucket_size",
           "FleetBucket", "PackedFleet", "pack_fleet", "SYNC_EVERY"]

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


def _done(state: _SwarmState, cfg: PSOGAConfig) -> torch.Tensor:
    """(N,) bool — which problems have hit the paper's stopping rule."""
    return (state.it >= cfg.max_iters) | (state.stall >= cfg.stall_iters)


def _run_fleet(ppb: PaddedProblem, X0: torch.Tensor, cfg: PSOGAConfig,
               draw: Optional[Callable[[int], SwarmDraws]],
               generators: Sequence[torch.Generator],
               record_history: bool = False
               ) -> Tuple[_SwarmState, Optional[torch.Tensor]]:
    """Iterate a stacked fleet of swarms to convergence.

    ``X0 (N, P, max_p)``; ``draw(step)`` gives the step's ``(N, P)``
    draws, else each problem draws from its own generator. Returns the
    final state and, with ``record_history`` (which runs exactly
    ``max_iters`` steps without freezing, as the reference's history mode
    does), the ``(N, max_iters)`` gBest keys.
    """
    max_p = X0.shape[-1]
    f0 = make_swarm_fitness(ppb, cfg.faithful_sim)(X0)        # (N, P)
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
        new = swarm_step(ppb, state, cfg,
                         draws=None if draw is None else draw(step),
                         generators=generators)
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
                     record_history: bool = False) -> List[PSOGAResult]:
    """Solve N offloading problems with one fleet of swarms per bucket,
    on ``device`` (``None`` = the card).

    ``seed`` is one seed for every problem or one per problem: problem i
    behaves exactly like ``run_pso_ga(..., seed=seed_i)``. ``X0`` (one
    ``(pop_size, p_i)`` swarm per problem) and ``draw_fn(i, step)``
    replace the generator's initial swarms and step draws, indexed by
    ORIGINAL problem index. Each bucket's epilogue scores its gBests as a
    one-row swarm through the same replay. Returns per-problem
    ``PSOGAResult`` in input order.
    """
    dev = resolve_device(device)
    probs = _as_problems(problems)
    n = len(probs)
    seeds = _normalize_seeds(seed, n)
    if X0 is not None and len(X0) != n:
        raise ValueError(f"{len(X0)} initial swarms for {n} problems")
    fleet = pack_fleet(probs, bucket=bucket, device=dev)
    results: List[Optional[PSOGAResult]] = [None] * n
    for b in fleet.buckets:
        gens, X0b = [], torch.zeros((len(b.idx), cfg.pop_size, b.max_p),
                                    dtype=torch.int32, device=dev)
        for j, i in enumerate(b.idx):
            g = torch.Generator(device=dev)
            g.manual_seed(seeds[i])
            gens.append(g)
            pr = probs[i]
            x0 = init_swarm(pr, cfg, g, dev) if X0 is None else \
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

        state, history = _run_fleet(b.ppb, X0b, cfg, draw, gens,
                                    record_history)
        total, feas, _ = schedule_replay(
            *kernel_args(b.ppb), state.gbest_x[:, None, :].contiguous(),
            faithful=cfg.faithful_sim)
        total, feas = total[:, 0].cpu().numpy(), feas[:, 0].cpu().numpy()
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
    return results
