"""Feasibility-aware fitness (paper §IV-B.2, Eq. 14–16), ported from
``repro.core.fitness`` (its non-traffic branch).

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

The tensors' device picks the replay: CUDA problems launch the
hand-written kernel, CPU problems run its plain PyTorch version.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.schedule_sim import schedule_replay
from .simulator import PaddedProblem, SimResult, kernel_args

#: Must exceed any attainable C_total; costs in both the paper fleet and the
#: TPU-fleet environment are well under $1e4 per request batch.
INFEASIBLE_OFFSET = 1e4

__all__ = ["INFEASIBLE_OFFSET", "fitness_key", "make_swarm_fitness",
           "migration_cost"]


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


def make_swarm_fitness(pp: PaddedProblem, faithful: bool = True,
                       incumbent: Optional[torch.Tensor] = None,
                       mig_weight=None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Swarm-fitness evaluator ``X (P, max_p) -> keys (P,)``; on a
    stacked ``pp``, ``X (N, P, max_p) -> keys (N, P)`` with one kernel
    launch for the whole fleet.

    With ``incumbent`` (``(max_p,)``, or ``(N, max_p)`` stacked) the key
    gains ``mig_weight`` (scalar or ``(N,)``; default 1) × the
    ``migration_cost`` of each particle."""
    args = kernel_args(pp)
    w = None
    if incumbent is not None:
        w = torch.as_tensor(1.0 if mig_weight is None else mig_weight,
                            dtype=torch.float32, device=pp.device)
        if w.dim() == 1:
            w = w[:, None]

    def fit(X: torch.Tensor) -> torch.Tensor:
        X = X.to(torch.int32).contiguous()
        total, feas, tsum = schedule_replay(
            *args, X if pp.stacked else X.unsqueeze(0), faithful=faithful)
        if not pp.stacked:
            total, feas, tsum = total[0], feas[0], tsum[0]
        if incumbent is not None:
            total = total + w * migration_cost(pp, X, incumbent)
        return torch.where(feas, total, INFEASIBLE_OFFSET + torch.log1p(tsum))
    return fit
