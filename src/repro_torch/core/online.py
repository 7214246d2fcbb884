"""Online re-planning for drifting fleets, ported from
``repro.core.online`` (DESIGN.md §9).

The paper solves a static snapshot; this module keeps a fleet's plans good
as the environment (or the request stream) drifts:

  * ``EnvTrace`` — a base ``Environment`` plus one ``DriftEvent`` per
    round, each scaling bandwidth / power / price per server, severing a
    churned node's links, or scaling the request stream's arrival rate.
    Shapes never change, only values.
  * ``sample_trace`` — the five drift families of ``TRACE_KINDS``
    (numpy, a copy of the reference's: the same seed gives the same trace
    bit for bit); ``zero_drift_trace`` — every epoch is the base.
  * ``replan_round`` / ``replan_fleet`` — at each drift event the fleet is
    re-solved by ``run_pso_ga_batch`` warm-started from the incumbent
    plans, with the Eq. 6-form migration term; a candidate replaces its
    incumbent only when its key strictly beats the incumbent's key under
    the new environment, so a drift-free round keeps every incumbent bit
    for bit. Incumbents that fail ``plan_is_valid`` are demoted to a cold
    solve.

``incumbent_keys`` scores every incumbent as a one-row swarm, one replay
launch per shape bucket: B1 at zero load, B2 under traffic, the shape the
solver's epilogue uses. ``telemetry=`` adds the reference's spans and
``online.*`` metrics. The reference's ``runner_cache_stats`` counts JAX's
compiled fleet runners; the port compiles nothing per shape, so it has no
counterpart. ``ReplanConfig.mesh`` shards every round's solves over a
device mesh (``launch.mesh``); plans, and so replan decisions, are the
same as on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from .batch import pack_arrivals, pack_fleet, run_pso_ga_batch
from .dag import LayerDAG
from .device import resolve_device
from .environment import CLOUD, DEVICE, EDGE, Environment
from .fitness import INFEASIBLE_OFFSET, make_swarm_fitness
from .pso_ga import PSOGAConfig, PSOGAResult
from .seeding import rng_entropy
from .simulator import SimProblem
from .telemetry import Telemetry, maybe_span
from .traffic import TrafficConfig

__all__ = ["DriftEvent", "EnvTrace", "ReplanConfig", "RoundLog",
           "OnlineReport", "sample_trace", "zero_drift_trace",
           "replan_round", "replan_fleet", "TRACE_KINDS",
           "incumbent_keys", "migration_cost_np", "plan_is_valid"]

TRACE_KINDS = ("wifi-fade", "congestion", "spot-price", "node-loss",
               "load-surge")


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One piecewise-constant epoch of the trace.

    Scales are multiplicative against the BASE environment (not the
    previous epoch), so a scale of 1 everywhere is exactly the base
    environment. ``down`` severs every off-diagonal link of the flagged
    servers (node churn): placements on them become link-infeasible.
    ``load_scale`` multiplies the request stream's arrival rate and leaves
    the environment untouched.
    """
    t: float                      # event time (s since trace start)
    label: str                    # human tag, e.g. "wifi-fade[0.41]"
    bw_scale: np.ndarray          # (S, S) on bandwidth (MB/s)
    power_scale: np.ndarray       # (S,)  on compute power
    price_scale: np.ndarray       # (S,)  on rental $/s
    down: np.ndarray              # (S,)  bool — server churned out
    load_scale: float = 1.0       # on request arrival rate (traffic)

    def __post_init__(self):
        # malformed drift events die here, not as NaN keys in a solve
        object.__setattr__(self, "bw_scale",
                           np.asarray(self.bw_scale, np.float64))
        object.__setattr__(self, "power_scale",
                           np.asarray(self.power_scale, np.float64))
        object.__setattr__(self, "price_scale",
                           np.asarray(self.price_scale, np.float64))
        object.__setattr__(self, "down", np.asarray(self.down, bool))
        s = self.down.shape[0] if self.down.ndim == 1 else -1
        if s < 1 or self.bw_scale.shape != (s, s) \
                or self.power_scale.shape != (s,) \
                or self.price_scale.shape != (s,):
            raise ValueError(
                f"malformed drift event {self.label!r}: expected "
                f"bw_scale (S, S) with power/price/down (S,), got "
                f"bw={self.bw_scale.shape} power={self.power_scale.shape} "
                f"price={self.price_scale.shape} down={self.down.shape}")
        for name in ("bw_scale", "power_scale", "price_scale"):
            arr = getattr(self, name)
            if not np.all(np.isfinite(arr)) or np.any(arr < 0.0):
                raise ValueError(f"drift event {self.label!r}: {name} "
                                 f"must be finite and >= 0")
        if not np.isfinite(self.t) or self.t < 0.0:
            raise ValueError(f"drift event {self.label!r}: t must be a "
                             f"finite time >= 0, got {self.t!r}")
        if not np.isfinite(self.load_scale) or self.load_scale <= 0.0:
            raise ValueError(f"drift event {self.label!r}: load_scale "
                             f"must be finite and > 0, "
                             f"got {self.load_scale!r}")

    @property
    def num_servers(self) -> int:
        return int(self.down.shape[0])

    def is_identity(self) -> bool:
        return (not self.down.any()
                and np.all(self.bw_scale == 1.0)
                and np.all(self.power_scale == 1.0)
                and np.all(self.price_scale == 1.0)
                and self.load_scale == 1.0)


@dataclasses.dataclass(frozen=True)
class EnvTrace:
    """A base environment plus one ``DriftEvent`` per re-planning round.

    ``events[0]`` is the admission-time epoch (the cold solve);
    ``env_at(k)`` materializes the environment of round ``k``. Every
    epoch has the same server count, so packed shapes never change.
    """
    base: Environment
    events: Tuple[DriftEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if not self.events:
            raise ValueError("EnvTrace needs at least one event "
                             "(round 0 is the admission-time epoch)")
        s = self.base.num_servers
        for k, ev in enumerate(self.events):
            if ev.num_servers != s:
                raise ValueError(
                    f"EnvTrace event {k} ({ev.label!r}) is sized for "
                    f"{ev.num_servers} servers but the base environment "
                    f"has {s} — shapes must never change across a trace")

    @property
    def num_rounds(self) -> int:
        return len(self.events)

    def env_at(self, k: int) -> Environment:
        ev = self.events[k]
        bw = self.base.bandwidth * ev.bw_scale
        if ev.down.any():
            off = ~np.eye(self.base.num_servers, dtype=bool)
            dead = ev.down[:, None] | ev.down[None, :]
            bw = np.where(dead & off, 0.0, bw)
        return Environment(
            power=np.maximum(self.base.power * ev.power_scale, 1e-12),
            cost_per_sec=self.base.cost_per_sec * ev.price_scale,
            tier=self.base.tier,
            bandwidth=bw,
            tran_cost=self.base.tran_cost)


def _identity_event(s: int, t: float, label: str) -> DriftEvent:
    return DriftEvent(t=t, label=label,
                      bw_scale=np.ones((s, s)),
                      power_scale=np.ones(s),
                      price_scale=np.ones(s),
                      down=np.zeros(s, bool))


def zero_drift_trace(env: Environment, rounds: int = 2,
                     period: float = 60.0) -> EnvTrace:
    """A trace whose every epoch IS the base environment (the warm-start
    parity fixture: replans must keep the incumbent bit for bit)."""
    s = env.num_servers
    return EnvTrace(base=env, events=tuple(
        _identity_event(s, k * period, "zero-drift")
        for k in range(rounds)))


def _tier_pair_mask(tier: np.ndarray, ta: int, tb: int) -> np.ndarray:
    """(S, S) bool — links whose endpoints are tiers {ta, tb} (symmetric)."""
    a = tier == ta
    b = tier == tb
    return (a[:, None] & b[None, :]) | (b[:, None] & a[None, :])


def sample_trace(kind: str, env: Environment, rounds: int,
                 seed: int = 0, period: float = 60.0,
                 severity: float = 0.6) -> EnvTrace:
    """Generate a drift trace of one of the ``TRACE_KINDS`` families.

    ``wifi-fade``  — WIFI device↔edge bandwidth fades on a bounded random
                     walk in [1 − severity, 1].
    ``congestion`` — WAN cloud↔{cloud, edge, device} bandwidth scaled by
                     congestion in [1 − severity, 1].
    ``spot-price`` — cloud-tier rental rates multiplied by a spot factor
                     in [1 − severity/2, 1 + severity].
    ``node-loss``  — one non-device server churns out per drift epoch
                     (links severed), recovering before the next draw.
    ``load-surge`` — the environment holds still; the request stream's
                     arrival rate is scaled by a surge factor in
                     [1, 1 + 7·severity] (used when ``replan_fleet``'s
                     config carries a ``TrafficConfig``).

    Round 0 is always the identity epoch (the cold solve's environment);
    events are ``period`` seconds apart.
    """
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r} "
                         f"(expected one of {TRACE_KINDS})")
    if int(rounds) < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds!r}")
    if not np.isfinite(period) or period <= 0.0:
        raise ValueError(f"period must be a positive finite number of "
                         f"seconds, got {period!r}")
    if not np.isfinite(severity) or not 0.0 < severity <= 1.0:
        raise ValueError(f"severity must be finite in (0, 1], "
                         f"got {severity!r}")
    rng = np.random.default_rng(rng_entropy(seed))
    s = env.num_servers
    tier = np.asarray(env.tier)
    events: List[DriftEvent] = [_identity_event(s, 0.0, f"{kind}[base]")]
    lo = 1.0 - severity
    fade = 1.0
    for k in range(1, rounds):
        ev = _identity_event(s, k * period, kind)
        if kind == "wifi-fade":
            fade = float(np.clip(fade + rng.uniform(-0.5, 0.35) * severity,
                                 lo, 1.0))
            m = _tier_pair_mask(tier, DEVICE, EDGE)
            bw = np.ones((s, s))
            bw[m] = fade
            ev = dataclasses.replace(ev, bw_scale=bw,
                                     label=f"wifi-fade[{fade:.2f}]")
        elif kind == "congestion":
            cong = float(rng.uniform(lo, 1.0))
            m = (_tier_pair_mask(tier, CLOUD, CLOUD)
                 | _tier_pair_mask(tier, CLOUD, EDGE)
                 | _tier_pair_mask(tier, CLOUD, DEVICE))
            bw = np.ones((s, s))
            bw[m] = cong
            ev = dataclasses.replace(ev, bw_scale=bw,
                                     label=f"congestion[{cong:.2f}]")
        elif kind == "spot-price":
            spot = float(rng.uniform(1.0 - severity / 2, 1.0 + severity))
            price = np.ones(s)
            price[tier == CLOUD] = spot
            ev = dataclasses.replace(ev, price_scale=price,
                                     label=f"spot-price[{spot:.2f}]")
        elif kind == "load-surge":
            surge = float(rng.uniform(1.0, 1.0 + 7.0 * severity))
            ev = dataclasses.replace(ev, load_scale=surge,
                                     label=f"load-surge[{surge:.1f}x]")
        else:                                   # node-loss
            cands = np.nonzero(tier != DEVICE)[0]
            victim = int(rng.choice(cands))
            down = np.zeros(s, bool)
            down[victim] = True
            ev = dataclasses.replace(ev, down=down,
                                     label=f"node-loss[s{victim}]")
        events.append(ev)
    return EnvTrace(base=env, events=tuple(events))


# ---------------------------------------------------------------------------
# the event-driven re-planning loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the warm-started re-planning loop."""
    pso: PSOGAConfig = PSOGAConfig(pop_size=32, max_iters=150,
                                   stall_iters=30)
    migration_weight: float = 1.0   # $ per Eq.6-MB of moved input dataset
    #: queue-aware re-planning: when set, every round solves under this
    #: request-stream model with the arrival rate scaled by the drift
    #: event's ``load_scale`` (the ``load-surge`` family drifts only that)
    traffic: Optional[TrafficConfig] = None
    #: device mesh for the fleet solver (a ``DeviceMesh``): every round's
    #: solve shards its buckets over the mesh's data axes, bit for bit
    #: the single-device solve
    mesh: Optional[object] = None


class RoundLog(NamedTuple):
    """Everything one drift event's replan decided, per problem."""
    round: int
    label: str
    replanned: np.ndarray        # (N,) bool — candidate accepted
    incumbent_key: np.ndarray    # (N,) incumbent fitness under NEW env
    candidate_key: np.ndarray    # (N,) warm gbest key (migration-adjusted)
    cost: np.ndarray             # (N,) final plan's raw cost this round
    migration: np.ndarray        # (N,) Eq.6-form $ paid to adopt the plan
    feasible: np.ndarray         # (N,) final plan feasible this round
    moved_layers: np.ndarray     # (N,) genes changed by the accepted plan
    iterations: np.ndarray       # (N,) warm-solve iterations executed
    converge_iters: np.ndarray   # (N,) iterations until the final gbest
    #   was found (it − stall at exit)
    wall_s: float                # replan wall-clock for the round
    demoted: np.ndarray = None   # (N,) bool — incumbent failed
    #   plan_is_valid and was cold-started instead of warm-seeded; its
    #   migration is 0 and moved_layers counts the full plan


@dataclasses.dataclass
class OnlineReport:
    """Output of ``replan_fleet``: the cold round-0 results plus one
    ``RoundLog`` per drift event, and the final surviving plans."""
    cold: List[PSOGAResult]
    rounds: List[RoundLog]
    plans: List[np.ndarray]      # final per-problem assignments

    def total_cost(self) -> float:
        """Σ over problems of the last round's plan cost."""
        if self.rounds:
            return float(np.sum(self.rounds[-1].cost))
        return float(sum(r.best_cost for r in self.cold
                         if np.isfinite(r.best_cost)))


def migration_cost_np(prob: SimProblem, old: np.ndarray,
                      new: np.ndarray) -> float:
    """Numpy twin of ``fitness.migration_cost`` for one assignment pair:
    every moved layer pays its input-dataset MBs over the old→new link."""
    old = np.asarray(old, np.int64)
    new = np.asarray(new, np.int64)
    input_mb = prob.parent_mb.sum(axis=1)
    moved = old != new
    return float(np.sum(np.where(moved,
                                 input_mb * prob.tran_cost[old, new], 0.0)))


def plan_is_valid(prob: SimProblem, plan) -> bool:
    """Static validity of one assignment under ``prob``'s environment.

    True iff ``plan`` is a 1-d integral vector of shape
    ``(num_layers,)`` whose genes are in ``[0, num_servers)``, honor the
    pins, and route every real DAG edge over a live link (``link_ok`` or
    same-server). This is the stale-plan guard: a stale incumbent after
    node churn, a NaN-poisoned array or a plan sized for another fleet
    must not warm-seed a swarm. Deadlines and cost are not checked: a
    deadline-stranded incumbent is still a legal warm seed.
    """
    x = np.asarray(plan)
    if x.ndim != 1 or x.shape[0] != prob.num_layers:
        return False
    if not np.issubdtype(x.dtype, np.integer):
        if not np.all(np.isfinite(x)) or not np.all(x == np.floor(x)):
            return False
    x = x.astype(np.int64)
    if np.any(x < 0) or np.any(x >= prob.num_servers):
        return False
    if np.any((prob.pinned >= 0) & (x != prob.pinned)):
        return False
    # every real parent edge must ride an OK link (same-server is free)
    pj = np.asarray(prob.parent_idx)
    real = pj >= 0
    src = x[np.where(real, pj, 0)]                 # (p, max_in)
    dst = x[:, None]
    edge_ok = np.asarray(prob.link_ok)[src, dst] | (src == dst)
    return bool(np.all(edge_ok | ~real))


def incumbent_keys(probs: Sequence[SimProblem],
                   incumbent: Sequence[Optional[np.ndarray]],
                   cfg: PSOGAConfig,
                   arrivals: Optional[Sequence[np.ndarray]] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> np.ndarray:
    """Fitness keys of the incumbent plans under ``probs``'s environment
    (no migration term: keeping the incumbent moves nothing), on
    ``device`` (``None`` = the card). With ``arrivals`` (per-problem
    Monte-Carlo draws) the keys are the queue-aware traffic keys under
    ``cfg.miss_budget``. A ``None`` entry (a demoted incumbent) keys as
    +inf, so any candidate strictly beats it.

    Evaluation is bucketed exactly like the solver (``pack_fleet``): each
    bucket scores its incumbents as one-row swarms in one replay launch
    (B1, or B2 under traffic) at the bucket's padded shape, so the
    incumbent's key and the warm candidate's come from the same replay.
    """
    dev = resolve_device(device)
    probs = list(probs)
    fleet = pack_fleet(probs, device=dev)
    keys = np.zeros(len(probs), np.float64)
    missing = np.zeros(len(probs), bool)
    for b in fleet.buckets:
        Xb = np.zeros((len(b.idx), 1, b.max_p), np.int32)
        for j, i in enumerate(b.idx):
            if incumbent[i] is None:
                missing[i] = True
            else:
                Xb[j, 0, :probs[i].num_layers] = np.asarray(incumbent[i],
                                                            np.int32)
        arrb = None if arrivals is None else pack_arrivals(
            [arrivals[i] for i in b.idx], fleet.max_apps)
        fit = make_swarm_fitness(b.ppb, cfg.faithful_sim, arrivals=arrb,
                                 miss_budget=cfg.miss_budget)
        keys[b.idx] = fit(torch.as_tensor(Xb, device=dev))[:, 0] \
            .cpu().numpy()
    keys[missing] = np.inf
    return keys


def replan_round(probs: Sequence[SimProblem],
                 incumbent: Sequence[Optional[np.ndarray]],
                 cfg: ReplanConfig = ReplanConfig(),
                 seed: int = 0,
                 round_no: int = 0,
                 label: str = "",
                 arrivals: Optional[Sequence[np.ndarray]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 X0: Optional[Sequence[np.ndarray]] = None,
                 draw_fn=None,
                 telemetry: Optional[Telemetry] = None
                 ) -> Tuple[List[np.ndarray], RoundLog]:
    """One drift event: warm re-solve the fleet, accept-if-better.

    ``probs`` carry the NEW (drifted) environment. Each problem's swarm
    is warm-started from its incumbent; the candidate's migration-
    adjusted key must STRICTLY beat the incumbent's key under the new
    environment to be accepted, so a zero-drift event keeps every
    incumbent bit for bit. An incumbent that fails ``plan_is_valid`` is
    demoted to a cold solve (migration 0, ``moved_layers`` the full
    plan); one stranded infeasible gets ``init_swarm``'s rescue anchors.

    With ``arrivals`` (the round's per-problem request-stream draws) both
    sides of the comparison are traffic keys, and ``feasible`` / ``cost``
    report the traffic key's verdict. ``X0`` and ``draw_fn`` pass through
    to ``run_pso_ga_batch`` (a test feeds the reference's warm swarms and
    step draws). Returns the surviving per-problem plans and the log.

    ``telemetry`` (DESIGN.md §13) wraps the round in a ``replan_round``
    span with ``incumbent_keys`` and ``warm_solve`` children, takes
    ``wall_s`` from its injectable clock, and counts replans and
    demotions under ``online.*``; plans are bit-identical with it on or
    off.
    """
    clock = telemetry.clock if telemetry is not None \
        else time.perf_counter
    with maybe_span(telemetry, "replan_round", round=round_no,
                    label=label, n=len(probs)):
        return _replan_round_body(probs, incumbent, cfg, seed, round_no,
                                  label, arrivals, device, X0, draw_fn,
                                  telemetry, clock)


def _replan_round_body(probs, incumbent, cfg, seed, round_no, label,
                       arrivals, device, X0, draw_fn, telemetry, clock
                       ) -> Tuple[List[np.ndarray], RoundLog]:
    n = len(probs)
    t0 = clock()
    checked: List[Optional[np.ndarray]] = []
    demoted = np.zeros(n, bool)
    for i, (pr, inc) in enumerate(zip(probs, incumbent)):
        if inc is not None and plan_is_valid(pr, inc):
            checked.append(np.asarray(inc, np.int32))
        else:
            demoted[i] = True
            checked.append(None)
    with maybe_span(telemetry, "incumbent_keys", round=round_no):
        inc_key = incumbent_keys(probs, checked, cfg.pso, arrivals=arrivals,
                                 device=device)
    rescue = inc_key >= INFEASIBLE_OFFSET
    with maybe_span(telemetry, "warm_solve", round=round_no, n=n):
        cand, state = run_pso_ga_batch(
            probs, cfg.pso, seed=seed, device=device, X0=X0,
            draw_fn=draw_fn, arrivals=arrivals, incumbent=checked,
            migration_weight=cfg.migration_weight, warm_rescue=rescue,
            return_state=True, mesh=cfg.mesh, telemetry=telemetry)
    wall = clock() - t0                    # the results are on the host

    plans: List[np.ndarray] = []
    replanned = np.zeros(n, bool)
    cand_key = np.array([c.best_fitness for c in cand], np.float64)
    cost = np.zeros(n)
    mig = np.zeros(n)
    feas = np.zeros(n, bool)
    moved = np.zeros(n, np.int64)
    iters = np.array([c.iterations for c in cand], np.int64)
    # the final gbest was found at it − stall; the rest is the stopping
    # rule confirming it
    converge = np.maximum(iters - state.stall.cpu().numpy().astype(np.int64),
                          0)
    for i, (pr, inc, c) in enumerate(zip(probs, checked, cand)):
        if demoted[i] or c.best_fitness < inc_key[i]:  # strict improvement
            replanned[i] = True
            plans.append(np.asarray(c.best_x, np.int32))
            # a demoted problem pays no migration: its candidate is a fresh
            # deployment, not a plan delta
            mig[i] = 0.0 if demoted[i] \
                else migration_cost_np(pr, inc, plans[-1])
            if arrivals is not None:
                # traffic keys: feasibility and $ come from the key (the
                # migration term stripped back off for the raw cost)
                feas[i] = c.best_fitness < INFEASIBLE_OFFSET
                cost[i] = (c.best_fitness
                           - cfg.migration_weight * mig[i]
                           if feas[i] else float("inf"))
            else:
                cost[i] = c.best_cost
                feas[i] = c.feasible
            moved[i] = pr.num_layers if demoted[i] \
                else int(np.sum(plans[-1] != inc))
        else:
            plans.append(inc)
            # keeping the incumbent: its key IS its raw cost if feasible
            feas[i] = inc_key[i] < INFEASIBLE_OFFSET
            cost[i] = float(inc_key[i]) if feas[i] else float("inf")
    log = RoundLog(round=round_no, label=label, replanned=replanned,
                   incumbent_key=inc_key, candidate_key=cand_key,
                   cost=cost, migration=mig, feasible=feas,
                   moved_layers=moved, iterations=iters,
                   converge_iters=converge, wall_s=wall, demoted=demoted)
    if telemetry is not None:
        telemetry.inc("online.rounds")
        telemetry.inc("online.replanned", int(replanned.sum()))
        telemetry.inc("online.demotions", int(demoted.sum()))
        telemetry.observe("online.round_wall_s", wall)
    return plans, log


def _round_arrivals(cfg: ReplanConfig, dags: Sequence[LayerDAG],
                    event: DriftEvent, seed: int
                    ) -> Optional[List[np.ndarray]]:
    """Per-problem solver arrival draws for one drift epoch: the base
    ``TrafficConfig`` rate scaled by the event's ``load_scale``."""
    if cfg.traffic is None:
        return None
    return [cfg.traffic.solver_arrivals(d.num_apps, seed=seed + 31 * i,
                                        rate_scale=event.load_scale)
            for i, d in enumerate(dags)]


def replan_fleet(dags: Sequence[LayerDAG], trace: EnvTrace,
                 cfg: ReplanConfig = ReplanConfig(),
                 seed: int = 0,
                 initial: Optional[Sequence[PSOGAResult]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 on_round: Optional[Callable[[RoundLog, List[np.ndarray]],
                                             None]] = None,
                 telemetry: Optional[Telemetry] = None
                 ) -> OnlineReport:
    """Drive a fleet of DNN placements through a drift trace, on
    ``device`` (``None`` = the card).

    Round 0 solves cold on ``trace.env_at(0)`` (unless ``initial`` hands
    in admission-time plans, e.g. from ``plan_offload_batch``); every
    later round is a warm ``replan_round`` against that round's drifted
    environment. With ``cfg.traffic`` set, every round also carries a
    request stream whose rate is scaled by the round's ``load_scale``.
    ``on_round(log, plans)`` is called after each round with the plans
    that survived it (a caller reads its kernels' launch counters there).
    ``telemetry`` wraps the cold solve in a ``cold_solve`` span and goes
    to every ``replan_round``.
    """
    if initial is None:
        probs0 = [SimProblem.build(d, trace.env_at(0)) for d in dags]
        with maybe_span(telemetry, "cold_solve", n=len(dags)):
            cold = run_pso_ga_batch(
                probs0, cfg.pso, seed=seed, device=device,
                arrivals=_round_arrivals(cfg, dags, trace.events[0], seed),
                mesh=cfg.mesh, telemetry=telemetry)
    else:
        if len(initial) != len(dags):
            raise ValueError(f"{len(initial)} initial results for "
                             f"{len(dags)} dags")
        cold = list(initial)
    plans = [np.asarray(r.best_x, np.int32) for r in cold]
    rounds: List[RoundLog] = []
    for k in range(1, trace.num_rounds):
        probs_k = [SimProblem.build(d, trace.env_at(k)) for d in dags]
        plans, log = replan_round(
            probs_k, plans, cfg, seed=seed + k, round_no=k,
            label=trace.events[k].label,
            arrivals=_round_arrivals(cfg, dags, trace.events[k],
                                     seed + 1000 * k),
            device=device, telemetry=telemetry)
        rounds.append(log)
        if on_round is not None:
            on_round(log, plans)
    return OnlineReport(cold=cold, rounds=rounds, plans=plans)
