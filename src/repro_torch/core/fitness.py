"""Feasibility-aware fitness (paper §IV-B.2, Eq. 14–16), ported from
``repro.core.fitness``.

The paper's three comparison cases —
  1. both feasible          → smaller C_total wins          (Eq. 14)
  2. one feasible           → the feasible particle wins     (Eq. 15)
  3. both infeasible        → smaller Σ T_i^comp wins        (Eq. 16)
— are induced by a single float32 scalar key:

    key(X) = C_total(X)                            if feasible(X)
           = INFEASIBLE_OFFSET + log1p(Σ T_i^comp) otherwise

``log1p`` keeps completion-time differences of up to ~1e9 s visible above
the offset in float32 and is strictly monotone, so the induced order on
infeasible particles is exactly Eq. 16's.

With an ``incumbent`` plan, every moved layer pays its input datasets over
the incumbent→candidate link's $/MB rate, scaled by ``mig_weight``
(online re-planning, DESIGN.md §9); a weight of 0 adds exactly 0.

With Monte-Carlo ``arrivals`` (DESIGN.md §10) the key is contention-aware:

    key(X) = mean_m C_total^load(X)                     if static_ok(X) and
                                                        p95_m(miss) <= budget
           = INFEASIBLE_OFFSET + MISS_PENALTY·p95_m(miss)
             + log1p(mean_m Σ latency)                  otherwise

so among over-budget plans fewer misses win first, then lower latency.

The tensors' device picks the replay: CUDA problems launch the
hand-written kernels, CPU problems run their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.schedule_sim import schedule_replay
from ..kernels.traffic_sim import traffic_replay
from .simulator import PaddedProblem, SimResult, kernel_args
from .traffic import TrafficInputs, percentile_linear, traffic_inputs

#: Must exceed any attainable C_total; costs in both the paper fleet and the
#: TPU-fleet environment are well under $1e4 per request batch.
INFEASIBLE_OFFSET = 1e4
#: Weight of the p95 deadline-miss rate in the infeasible traffic key: the
#: rate lies in [0, 1] and the latency tail is log-compressed to <~21, so 64
#: lets a few points of miss rate dominate any latency difference without
#: swamping the offset.
MISS_PENALTY = 64.0

__all__ = ["INFEASIBLE_OFFSET", "MISS_PENALTY", "fitness_key",
           "make_swarm_fitness", "migration_cost"]


def fitness_key(res: SimResult) -> torch.Tensor:
    total_time = torch.as_tensor(res.app_completion).sum(-1)
    infeasible_key = INFEASIBLE_OFFSET + torch.log1p(total_time)
    return torch.where(torch.as_tensor(res.feasible),
                       torch.as_tensor(res.total_cost), infeasible_key)


def migration_cost(pp: PaddedProblem, X: torch.Tensor,
                   incumbent: torch.Tensor) -> torch.Tensor:
    """Per-particle plan-delta cost (Eq. 6 form, DESIGN.md §9).

    ``X (..., P, max_p)`` against ``incumbent (..., max_p)`` (a leading
    fleet axis on both when ``pp`` is stacked): every moved layer pays the
    sum of its incoming edge MBs at the incumbent→candidate $/MB rate.
    Padded layers have zero ``parent_mb`` and never move, so they add 0.
    """
    inc = torch.as_tensor(incumbent, device=pp.device).to(torch.int32)
    if not pp.stacked:
        return migration_cost(
            PaddedProblem(*(f.unsqueeze(0) for f in pp)), X.unsqueeze(0),
            inc.unsqueeze(0))[0]
    n, S = pp.tran_cost.shape[0], pp.max_servers
    input_mb = pp.parent_mb.sum(-1)                          # (N, max_p)
    idx = inc.long()[:, None, :] * S + X.long()              # (N, P, max_p)
    rate = pp.tran_cost.reshape(n, S * S).gather(
        1, idx.reshape(n, -1)).reshape(idx.shape)
    moved = X != inc[:, None, :]
    return torch.where(moved, input_mb[:, None, :] * rate, 0.0).sum(-1)


def draw_mean(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean(t, axis=dim)`` over the M arrival draws as the
    reference's jitted solver computes it on the CPU: XLA turns the
    division into a multiply by ``f32(1/M)``, and LLVM vectorizes the
    sum over eight lanes when M is a multiple of 8 (lane l adds draws
    l, l+8, ...; the lanes are then folded in halves), over four halved
    lanes at M = 4, and adds left to right otherwise. Checked against
    the jitted reference key for M = 1..16, 24, 32 and 40; its sums over
    servers can still round apart from the port's in the last ulp for
    other M (the keys then agree to rtol 1e-5)."""
    M = t.shape[dim]
    lanes = 8 if M % 8 == 0 else 4 if M == 4 else 1
    t = t.movedim(dim, -1)
    acc = t[..., :lanes]
    for k in range(lanes, M, lanes):
        acc = acc + t[..., k:k + lanes]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0] * float(np.float32(1.0) / np.float32(M))


def make_swarm_fitness(pp: PaddedProblem, faithful: bool = True,
                       incumbent: Optional[torch.Tensor] = None,
                       mig_weight=None, arrivals=None,
                       miss_budget: Optional[float] = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Swarm-fitness evaluator ``X (P, max_p) -> keys (P,)``; on a
    stacked ``pp``, ``X (N, P, max_p) -> keys (N, P)`` with one kernel
    launch for the whole fleet.

    With ``incumbent`` (``(max_p,)``, or ``(N, max_p)`` stacked) the key
    gains ``mig_weight`` (scalar or ``(N,)``; default 1) × the
    ``migration_cost`` of each particle.

    With ``arrivals`` (``(M, max_apps, R)`` Monte-Carlo request times,
    +inf padded; ``(N, M, max_apps, R)`` stacked) the key is the traffic
    key under the p95 ``miss_budget`` (default 0.05). The arrivals do not
    change during a solve, so their merged orders are built here, once
    (or passed in already built, as ``TrafficInputs``); each call is one
    traffic-replay launch for all M draws and all N problems."""
    args = kernel_args(pp)
    w = None
    if incumbent is not None:
        w = torch.as_tensor(1.0 if mig_weight is None else mig_weight,
                            dtype=torch.float32, device=pp.device)
        if w.dim() == 1:
            w = w[:, None]

    def fleet(X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.int32).contiguous()
        return X if pp.stacked else X.unsqueeze(0)

    def with_migration(cost: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        if incumbent is None:
            return cost
        return cost + w * migration_cost(pp, X, incumbent)

    if arrivals is not None:
        tin = arrivals if isinstance(arrivals, TrafficInputs) \
            else traffic_inputs(pp, arrivals)
        M = tin.n_valid.shape[1]
        # compared in float32, as the reference's weakly typed scalar
        budget = float(np.float32(0.05 if miss_budget is None
                                  else miss_budget))

        def fit_traffic(X: torch.Tensor) -> torch.Tensor:
            total, miss, lat, static_ok, _ = traffic_replay(
                *args, fleet(X), *tin, faithful=faithful)
            p95 = percentile_linear(miss, 95.0, dim=1)
            cost, lat = draw_mean(total, 1), draw_mean(lat, 1)
            if not pp.stacked:
                cost, lat, p95, static_ok = cost[0], lat[0], p95[0], \
                    static_ok[0]
            return torch.where(static_ok & (p95 <= budget),
                               with_migration(cost, X),
                               INFEASIBLE_OFFSET + MISS_PENALTY * p95
                               + torch.log1p(lat))
        return fit_traffic

    def fit(X: torch.Tensor) -> torch.Tensor:
        total, feas, tsum = schedule_replay(*args, fleet(X),
                                            faithful=faithful)
        if not pp.stacked:
            total, feas, tsum = total[0], feas[0], tsum[0]
        return torch.where(feas, with_migration(total, X),
                           INFEASIBLE_OFFSET + torch.log1p(tsum))
    return fit
