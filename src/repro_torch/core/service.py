"""Fault-tolerant always-on planning service (DESIGN.md §11), ported from
``repro.core.service``: the same supervision logic around the port's
``replan_round`` and ``run_pso_ga_batch``, whose every solve scores its
particles through B1 (zero load) or B2 (under traffic) on the card.

``replan_fleet`` (DESIGN.md §9) is a batch loop: hand it a complete
drift trace, get back every round's plans. A deployed planner runs
*forever*, ingests arrivals as they happen, and its failure modes are
the interesting part: the solver crashes, an environment snapshot
arrives NaN-poisoned, a node churns out between solve and deploy, a
solve stalls past the time-to-plan SLO. This module wraps the
re-planner in the supervision layer that makes it deployable:

  * **service loop** — ``run_service`` drives a fleet through an
    ``EnvTrace`` one round at a time, warm-starting from the surviving
    plans exactly like ``replan_fleet``; with every protection disabled
    its output is bit-identical to the batch loop.
  * **streaming rate estimation** — with ``estimate_rates`` the service
    ignores the trace's ``load_scale`` and instead *observes* one
    arrival draw per round, slides it into a bounded window
    (``_RateWindow``), and solves against arrivals resampled at the
    estimated rate.
  * **solver watchdog** — an ``EwmaEstimator`` of per-iteration solve
    seconds converts the remaining SLO slack into an iteration budget;
    a budget below a rung's ``max_iters`` demotes the round down the
    ladder *before* the solve starts. Rungs are two FIXED configs (warm
    and burst), as in the reference.
  * **graceful-degradation ladder** — warm PSO → short-burst PSO →
    pinned → HEFT → greedy → reject. Every rung's plan must pass
    ``_plan_ok`` (static validity via ``plan_is_valid`` + finite
    simulated cost) under the environment it will actually run on
    before promotion; per-rung counts land in
    ``ServiceReport.fallback_counts``.
  * **admission control / deadline triage** — ``triage_margin`` rejects
    apps whose deadline not even a HEFT schedule could meet: their
    arrival slots are masked to +inf so they never poison the shared
    FCFS queues the admitted apps ride (DESIGN.md §10).
  * **plan cache** — rounds whose (DNN, env-bucket, load-bucket) keys
    hold stored plans that pass the replay-exact gate skip
    ``replan_round`` and serve from cache (rung ``cached``); cached
    plans still walk the ladder's ``_plan_ok`` gate against the
    post-churn env (``core.plancache``).
  * **async request ingestion** — with ``ingest`` set, the rate
    estimator's observations flow through a bounded ``ArrivalQueue``;
    ``threads=0`` is the deterministic single-thread mode (bit-identical
    to the synchronous path), ``threads>0`` pre-draws observations in
    producer threads with numpy while the round loop launches kernels.
  * **multi-service sharing** — ``run_services`` runs N service loops
    on threads against the same card; the replay wrappers' tables,
    library loads and launch counters are locked
    (``kernels.schedule_sim.LOCK``), and each loop's solves are seeded
    and self-contained, so every report equals its service run alone.
    An optional shared ``PlanCache`` lets services reuse each other's
    solves.
  * **chaos harness** — ``ChaosConfig`` wires ``runtime.fault``'s
    ``FailureInjector`` and ``runtime.straggler``'s detector into the
    loop: injected solver crashes (retried with backoff, then circuit-
    broken), NaN env snapshots (rejected by ``_env_ok``, last-good env
    substituted), mid-round node loss (plans re-validated against the
    post-drift environment, invalid ones re-laddered), and solve stalls.

Everything is deterministic given the seed: injected failures fire at
configured rounds, backoff sleeps go through an injectable sleeper, and
the breaker runs on round numbers, not wall clocks. Every entry point
solves on ``device`` (``None`` = the card). The reference's
``runner_cache.*`` gauges count JAX's compiled fleet runners and have no
counterpart here (the port compiles nothing per shape).

With ``cfg.replan.mesh`` every solve is sharded over a device mesh and
every rank runs the same loop. Only the solve is collective, so each
host decision that a clock, a thread or a shared cache could make
differently on two ranks is made on rank 0 and broadcast before it steers
anything (``launch.mesh.agree``): the rate estimates, the cache lookup's
verdict and plans, and each round's measured wall (from which the
watchdog, the straggler detector and the breaker decide).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from ..runtime.fault import (CircuitBreaker, FailureInjector,
                             SimulatedFailure, retry_with_backoff)
from ..runtime.straggler import EwmaEstimator, StragglerDetector
from .baselines import greedy_offload, heft_makespan
from .batch import run_pso_ga_batch
from .dag import LayerDAG
from .environment import Environment
from .online import (EnvTrace, ReplanConfig, RoundLog, _round_arrivals,
                     plan_is_valid, replan_round)
from .plancache import PlanCache, PlanCacheConfig, dag_fingerprint
from .pso_ga import PSOGAConfig, PSOGAResult
from .simulator import SimProblem, simulate_np
from .telemetry import Telemetry, get_telemetry, maybe_span
from .traffic import ArrivalQueue, IngestConfig

__all__ = ["ChaosConfig", "ServiceConfig", "ServiceRoundLog",
           "ServiceReport", "run_service", "run_services", "LADDER_RUNGS"]

#: the graceful-degradation ladder, best rung first. ``cached`` serves a
#: stored plan that survived the replay-exact gate without solving;
#: ``pinned`` is the circuit-breaker rung (serve the last-good plan
#: without solving).
LADDER_RUNGS = ("cached", "warm", "burst", "pinned", "heft", "greedy",
                "reject")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection for the service loop.

    ``crash_rounds`` / ``p_crash`` feed a ``FailureInjector`` whose
    ``maybe_fail`` runs at the top of every solve attempt — a configured
    round crashes the first attempt and (having fired) lets the retry
    through, while ``p_crash`` failures are persistent enough to exhaust
    retries and trip the breaker. ``nan_env_rounds`` poison the round's
    environment snapshot with NaN bandwidth before validation;
    ``stall_rounds`` add ``stall_s`` simulated seconds to the measured
    solve time (nothing actually sleeps); ``mid_round_down`` churns a
    server out AFTER the round's solve, so the freshly-accepted plans
    must survive re-validation against an environment they never saw.
    """
    crash_rounds: Tuple[int, ...] = ()
    p_crash: float = 0.0
    seed: int = 0
    max_crashes: int = 1_000_000
    nan_env_rounds: Tuple[int, ...] = ()
    stall_rounds: Tuple[int, ...] = ()
    stall_s: float = 30.0
    mid_round_down: Mapping[int, int] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if not np.isfinite(self.p_crash) or not 0.0 <= self.p_crash <= 1.0:
            raise ValueError(f"p_crash must be in [0, 1], "
                             f"got {self.p_crash!r}")
        if not np.isfinite(self.stall_s) or self.stall_s < 0.0:
            raise ValueError(f"stall_s must be finite and >= 0, "
                             f"got {self.stall_s!r}")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the always-on planning service (DESIGN.md §11). ``replan``
    is the port's ``ReplanConfig`` (its ``mesh`` shards every solve).

    The defaults disable every protection that could change plans —
    ``slo_s`` infinite (watchdog never cuts), ``triage_margin`` 0
    (admit everything), ``estimate_rates`` off (the solver sees the
    trace's own arrivals), no chaos — which is exactly the configuration
    under which ``run_service`` is bit-identical to ``replan_fleet``.
    """
    replan: ReplanConfig = ReplanConfig()
    #: the short-burst rung's solver: a FIXED config, not a per-round
    #: ``max_iters``, as in the reference.
    burst: PSOGAConfig = PSOGAConfig(pop_size=16, max_iters=24,
                                     stall_iters=12)
    slo_s: float = float("inf")     # per-round time-to-plan SLO (s)
    triage_margin: float = 0.0      # reject app if margin·HEFT > deadline
    estimate_rates: bool = False    # solve on observed, not configured, rates
    window_rounds: int = 4          # sliding observation window (rounds)
    retries: int = 2                # solve retries before giving up
    backoff_s: float = 0.0          # base backoff between retries
    breaker_threshold: int = 2      # consecutive failures to open
    breaker_cooldown: int = 2       # rounds the breaker stays open
    treat_stalls_as_failures: bool = False
    straggler_warmup: int = 2       # detector warmup (first rounds build)
    chaos: Optional[ChaosConfig] = None
    #: phase 2: plan cache over (DNN, env-bucket, load-bucket) keys —
    #: None keeps every round solving (the parity configuration).
    plan_cache: Optional[PlanCacheConfig] = None
    #: phase 2: route rate observations through a bounded ArrivalQueue;
    #: requires ``estimate_rates`` (there is no stream to ingest
    #: otherwise). None keeps the legacy synchronous draws.
    ingest: Optional[IngestConfig] = None

    def __post_init__(self):
        if self.slo_s <= 0.0 or np.isnan(self.slo_s):
            raise ValueError(f"slo_s must be > 0, got {self.slo_s!r}")
        if self.ingest is not None and not self.estimate_rates:
            raise ValueError("ingest requires estimate_rates=True — "
                             "without rate estimation there is no "
                             "observation stream to ingest")
        if not np.isfinite(self.triage_margin) or self.triage_margin < 0.0:
            raise ValueError(f"triage_margin must be finite and >= 0, "
                             f"got {self.triage_margin!r}")
        if self.window_rounds < 1:
            raise ValueError(f"window_rounds must be >= 1, "
                             f"got {self.window_rounds!r}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries!r}")


class ServiceRoundLog(NamedTuple):
    """What the service decided for one round, per problem."""
    round: int
    label: str
    rung: Tuple[str, ...]        # ladder rung that served each problem
    wall_s: float                # measured time-to-plan (incl. injected stall)
    budget_iters: float          # watchdog's iteration budget (inf = no cap)
    breaker_state: str           # breaker state when the round started
    solver_failed: bool          # PSO rung crashed/stalled out this round
    retries_used: int            # extra solve attempts consumed
    stale_env: bool              # env snapshot rejected, last-good used
    stalled: bool                # straggler detector flagged the solve
    rejected_apps: int           # apps triaged out of the shared queues
    est_rates: Tuple[float, ...]  # per-DAG observed-rate estimates
                                  # (empty when estimation is off)
    replan: Optional[RoundLog]   # the PSO rung's log (None when skipped)
    cache_hit: bool = False      # every problem served from the plan cache


@dataclasses.dataclass
class ServiceReport:
    """Output of ``run_service``: per-round logs plus the counters the
    availability/SLO story is told from (EXPERIMENTS.md §Service)."""
    cold: List[PSOGAResult]
    rounds: List[ServiceRoundLog]
    plans: List[Optional[np.ndarray]]   # final per-problem plans
    fallback_counts: Dict[str, int]     # problem-rounds served per rung
    counters: Dict[str, int]
    #: plan-cache counters snapshot (None when the cache is off). With a
    #: shared cache the snapshot is taken at this service's exit, so it
    #: includes every sharer's traffic up to that point.
    cache_stats: Optional[Dict[str, int]] = None

    def availability(self) -> float:
        """Fraction of problem-rounds served a valid plan (any rung but
        ``reject``)."""
        total = sum(len(r.rung) for r in self.rounds)
        if total == 0:
            return 1.0
        served = sum(1 for r in self.rounds for g in r.rung
                     if g != "reject")
        return served / total

    def time_to_plan(self) -> Dict[str, float]:
        walls = np.array([r.wall_s for r in self.rounds], float)
        if walls.size == 0:
            return {"p50": 0.0, "p99": 0.0, "max": 0.0}
        return {"p50": float(np.percentile(walls, 50)),
                "p99": float(np.percentile(walls, 99)),
                "max": float(walls.max())}

    def summary(self) -> Dict[str, object]:
        out = {"rounds": len(self.rounds),
               "availability": self.availability(),
               "time_to_plan_s": self.time_to_plan(),
               "fallback_counts": dict(self.fallback_counts),
               "counters": dict(self.counters)}
        if self.cache_stats is not None:
            out["cache_stats"] = dict(self.cache_stats)
        return out


class _RateWindow:
    """Sliding window of observed per-round arrival draws: the
    streaming-ingestion half of the service (DESIGN.md §11). Each round
    contributes one ``(n_apps, R)`` timestamp array; the rate estimate
    is finite-count / (rounds · apps · horizon) over the window."""

    def __init__(self, window_rounds: int, horizon: float, n_apps: int):
        self._obs = collections.deque(maxlen=window_rounds)
        self._horizon = horizon
        self._n_apps = n_apps

    def ingest(self, arrivals: np.ndarray) -> None:
        self._obs.append(int(np.isfinite(arrivals).sum()))

    def rate(self) -> Optional[float]:
        """Estimated requests/s/app, None before the first observation."""
        if not self._obs:
            return None
        span = len(self._obs) * self._horizon * self._n_apps
        return sum(self._obs) / span


def _env_ok(env: Environment) -> bool:
    """A usable environment snapshot: finite positive power, no NaN
    anywhere a cost could flow from (DESIGN.md §11 — a NaN bandwidth
    becomes a NaN fitness key, and a NaN key freezes PSO's argmin).
    Bandwidth of +inf is legal (the self-link convention) and 0 is a
    severed link, so only NaN/negative entries disqualify it."""
    bw = np.asarray(env.bandwidth, float)
    return bool(np.all(np.isfinite(env.power)) and np.all(env.power > 0.0)
                and not np.any(np.isnan(bw)) and np.all(bw >= 0.0)
                and np.all(np.isfinite(env.cost_per_sec))
                and np.all(np.isfinite(env.tran_cost)))


def _poison_env(env: Environment) -> Environment:
    """The chaos harness's stale-snapshot fault: NaN bandwidth."""
    bw = np.asarray(env.bandwidth, float).copy()
    bw[0, -1] = np.nan
    return dataclasses.replace(env, bandwidth=bw)


def _down_env(env: Environment, server: int) -> Environment:
    """Sever every off-diagonal link of ``server`` (mid-round churn)."""
    s = env.num_servers
    bw = np.asarray(env.bandwidth, float).copy()
    off = ~np.eye(s, dtype=bool)
    dead = np.zeros(s, bool)
    dead[server] = True
    bw[(dead[:, None] | dead[None, :]) & off] = 0.0
    return dataclasses.replace(env, bandwidth=bw)


def _select_rung(budget_iters: float, warm_iters: int,
                 burst_iters: int) -> str:
    """The watchdog's rung choice: the best PSO rung whose iteration
    count fits the budget, else skip the solver entirely and pin
    (DESIGN.md §11). Budgets are compared against the rungs' FIXED
    ``max_iters``, never a per-round cap."""
    if budget_iters >= warm_iters:
        return "warm"
    if budget_iters >= burst_iters:
        return "burst"
    return "pinned"


def _plan_ok(prob: SimProblem, plan: Optional[np.ndarray]) -> bool:
    """The ladder's promotion gate: static validity (shape, genes in
    range, pins honored, every edge on a live link) plus a finite
    replayed cost. Deadline misses do NOT fail the gate — a late plan is
    a triage/fitness concern, not an invalid one."""
    if plan is None or not plan_is_valid(prob, plan):
        return False
    res = simulate_np(prob, np.asarray(plan, np.int64))
    return bool(np.isfinite(float(res.total_cost))
                and np.isfinite(float(res.makespan)))


def _triage(dags: Sequence[LayerDAG], probs: Sequence[SimProblem],
            env: Environment, margin: float,
            arrivals: Optional[List[np.ndarray]]
            ) -> Tuple[Optional[List[np.ndarray]], int]:
    """Deadline triage (DESIGN.md §11): an app whose deadline even a
    HEFT makespan-minimizing schedule cannot meet within ``margin`` is
    rejected — its arrival slots go to +inf so the shared FCFS queues
    only carry savable work. Returns (masked arrivals, rejected apps)."""
    if margin <= 0.0 or arrivals is None:
        return arrivals, 0
    rejected = 0
    masked: List[np.ndarray] = []
    for dag, prob, arr in zip(dags, probs, arrivals):
        _, x_h = heft_makespan(dag, env)
        comp = np.asarray(simulate_np(prob, x_h).app_completion, float)
        bad = margin * comp > np.asarray(dag.deadline, float)
        if bad.any():
            arr = np.asarray(arr, float).copy()
            arr[:, bad, :] = np.inf
            rejected += int(bad.sum())
        masked.append(arr)
    return masked, rejected


def _ladder_tail(dag: LayerDAG, prob: SimProblem, env: Environment,
                 faithful: bool) -> Tuple[str, Optional[np.ndarray]]:
    """HEFT → greedy → reject: the solver-free rungs, each validated
    before promotion (greedy's last-candidate fallback can emit a
    link-infeasible plan after node churn — the gate catches it)."""
    _, x_h = heft_makespan(dag, env)
    if _plan_ok(prob, x_h):
        return "heft", np.asarray(x_h, np.int32)
    g = greedy_offload(dag, env, faithful=faithful)
    x_g = np.asarray(g.best_x, np.int32)
    if _plan_ok(prob, x_g):
        return "greedy", x_g
    return "reject", None


def run_service(dags: Sequence[LayerDAG], trace: EnvTrace,
                cfg: ServiceConfig = ServiceConfig(),
                seed: int = 0,
                initial: Optional[Sequence[PSOGAResult]] = None,
                sleeper=None,
                plan_cache: Optional[PlanCache] = None,
                telemetry: Optional[Telemetry] = None,
                track: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None,
                on_round: Optional[Callable[[ServiceRoundLog,
                                             List[Optional[np.ndarray]]],
                                            None]] = None
                ) -> ServiceReport:
    """Drive a fleet through a drift trace as a long-running service.

    Round 0 solves cold exactly like ``replan_fleet``; every later round
    runs the fault-tolerant pipeline: validate the env snapshot →
    estimate arrival rates (or reuse the trace's) → consult the plan
    cache (a full-fleet hit that survives the replay-exact gate serves
    immediately, rung ``cached``) → triage unsavable apps → pick a PSO
    rung within the watchdog's iteration budget → solve with retries
    under the circuit breaker → apply any mid-round churn → walk every
    problem down the ladder until a rung's plan passes ``_plan_ok`` →
    store freshly-solved plans back into the cache. Surviving plans are
    the next round's incumbents; a rejected problem re-enters cold (the
    stale-plan guard accepts ``None`` incumbents).

    With every protection at its default-off setting the loop IS
    ``replan_fleet`` step for step — same seeds, same arrivals, same
    accept-if-better — so plans match bit-for-bit (the parity test).
    ``sleeper`` is handed to ``retry_with_backoff`` (tests inject a
    recorder so chaos runs never block). ``plan_cache`` overrides
    ``cfg.plan_cache`` with a caller-owned (possibly shared) cache
    instance.

    ``telemetry`` (DESIGN.md §13) routes every round through the span
    tracer (round / cache_lookup / solve / ladder spans on the
    service's ``track``) and mirrors the ad-hoc counters onto the
    metrics registry under ``service.*``; all wall measurements come
    from its injectable clock (``time.perf_counter`` with telemetry
    off), so a fake clock makes every ``wall_s`` deterministic. Plans,
    seeds, and every ``ServiceReport`` field are bit-identical with
    telemetry on, off, or globally installed — telemetry observes, it
    never steers.

    ``device`` (``None`` = the card) is where every solve runs: the cold
    solve, each round's ``replan_round`` and its ``incumbent_keys``.
    ``on_round(log, plans)`` is called after each round with the plans
    served (a caller reads the replay kernels' launch counters there).
    """
    tel = telemetry if telemetry is not None else get_telemetry()
    clock = tel.clock if tel is not None else time.perf_counter
    if tel is not None and track is not None:
        tel.set_track(track, label=f"service-{track}")

    def _bump(name: str, n: int = 1) -> None:
        counters[name] += n
        if tel is not None and n:
            tel.inc(f"service.{name}", n)

    rcfg = cfg.replan
    mesh = rcfg.mesh
    from ..launch.mesh import agree   # launch.mesh imports core: lazy
    burst_rcfg = dataclasses.replace(rcfg, pso=cfg.burst)
    cache = plan_cache
    if cache is None and cfg.plan_cache is not None:
        cache = PlanCache(cfg.plan_cache, telemetry=tel)
    fps = [dag_fingerprint(d) for d in dags] if cache is not None else None
    injector = None
    if cfg.chaos is not None and (cfg.chaos.crash_rounds
                                  or cfg.chaos.p_crash > 0.0):
        injector = FailureInjector(p_fail=cfg.chaos.p_crash,
                                   seed=cfg.chaos.seed,
                                   fail_at=tuple(cfg.chaos.crash_rounds),
                                   max_failures=cfg.chaos.max_crashes)
    breaker = CircuitBreaker(threshold=cfg.breaker_threshold,
                             cooldown=cfg.breaker_cooldown)
    detector = StragglerDetector(warmup=cfg.straggler_warmup)
    per_iter = EwmaEstimator()
    windows: Optional[List[_RateWindow]] = None
    if cfg.estimate_rates and rcfg.traffic is not None:
        windows = [_RateWindow(cfg.window_rounds, rcfg.traffic.horizon,
                               d.num_apps) for d in dags]

    def _observe(k: int, i: int) -> Tuple[int, int, np.ndarray]:
        """One (round, dag, timestamps) arrival observation — the exact
        draw the synchronous estimate_rates path makes in-loop, so the
        deterministic ingestion mode is bit-identical to it."""
        tc = rcfg.traffic
        obs = tc.solver_arrivals(
            dags[i].num_apps, seed=seed + 7919 * k + 31 * i,
            rate_scale=trace.events[k].load_scale)[0]
        return (k, i, obs)

    # async ingestion (phase 2): observations ride a bounded queue. With
    # threads=0 the round loop enqueues its own round synchronously —
    # deterministic and bit-identical to the legacy path; with threads>0
    # producers pre-draw future rounds' observations concurrently.
    queue: Optional[ArrivalQueue] = None
    producers: List[threading.Thread] = []
    stop = threading.Event()
    if cfg.ingest is not None:
        if windows is None:
            raise ValueError("ingest requires a traffic model "
                             "(cfg.replan.traffic) to observe")
        queue = ArrivalQueue(cfg.ingest.capacity, telemetry=tel)

        def _produce(idxs: List[int]) -> None:
            for kk in range(1, trace.num_rounds):
                for ii in idxs:
                    if stop.is_set():
                        return
                    queue.put(_observe(kk, ii))

        n_threads = min(int(cfg.ingest.threads), len(dags))
        for t in range(n_threads):
            th = threading.Thread(
                target=_produce, args=(list(range(t, len(dags),
                                                  n_threads)),),
                daemon=True)
            producers.append(th)
            th.start()

    # the counters schema is STABLE: every key is present from round 0
    # (ingest_* stay 0 without async ingestion) so downstream consumers
    # never need existence checks.
    counters = {"retries": 0, "crashes": 0, "stale_env_rounds": 0,
                "stalls_flagged": 0, "breaker_opened": 0,
                "watchdog_cuts": 0, "rejected_apps": 0, "demotions": 0,
                "ingest_enqueued": 0, "ingest_dropped": 0,
                "ingest_drained": 0, "ingest_leftover": 0}
    fallback_counts = {r: 0 for r in LADDER_RUNGS}

    # round 0: the cold solve, exactly replan_fleet's (or admission-time
    # plans handed in, e.g. from plan_offload_batch).
    env0 = trace.env_at(0)
    if initial is None:
        probs0 = [SimProblem.build(d, env0) for d in dags]
        with maybe_span(tel, "cold_solve", n=len(dags)):
            cold = run_pso_ga_batch(
                probs0, rcfg.pso, seed=seed, device=device,
                arrivals=_round_arrivals(rcfg, dags, trace.events[0],
                                         seed),
                mesh=mesh, telemetry=tel)
    else:
        if len(initial) != len(dags):
            raise ValueError(f"{len(initial)} initial results for "
                             f"{len(dags)} dags")
        cold = list(initial)
    plans: List[Optional[np.ndarray]] = [
        np.asarray(r.best_x, np.int32) for r in cold]
    last_good_env = env0
    rounds: List[ServiceRoundLog] = []

    for k in range(1, trace.num_rounds):
      ev = trace.events[k]
      with maybe_span(tel, "round", round=k, label=ev.label):
        env_k = trace.env_at(k)
        if cfg.chaos is not None and k in cfg.chaos.nan_env_rounds:
            env_k = _poison_env(env_k)
        stale_env = not _env_ok(env_k)
        if stale_env:
            _bump("stale_env_rounds")
            if tel is not None:
                tel.instant("stale_env", round=k)
            env_k = last_good_env
        else:
            last_good_env = env_k
        probs = [SimProblem.build(d, env_k) for d in dags]

        # rate estimation: ingest this round's observations — via the
        # bounded queue when async ingestion is on, else the legacy
        # synchronous draws — and slide them into the per-DAG windows
        # (the solver never sees the trace's load_scale).
        est_rates: Tuple[float, ...] = ()
        if windows is not None:
          with maybe_span(tel, "ingest", round=k):
            tc = rcfg.traffic
            if queue is not None:
                if not producers:   # deterministic single-thread mode
                    for i in range(len(dags)):
                        queue.put(_observe(k, i))
                for _, i, obs in queue.drain():
                    windows[i].ingest(obs)
            else:
                for i in range(len(dags)):
                    windows[i].ingest(_observe(k, i)[2])
            ests = [windows[i].rate() for i in range(len(dags))]
            est_rates = agree(mesh, tuple(
                tc.rate if e is None else float(e) for e in ests))
            if tel is not None:
                for e in est_rates:
                    tel.observe("service.est_rate", e)

        # plan cache: a full-fleet hit that survives the replay-exact
        # gate serves instantly and skips triage/watchdog/solve.
        cache_hit = False
        keys_k: Optional[List[tuple]] = None
        cached_plans: Optional[List[np.ndarray]] = None
        cache_wall = 0.0
        if cache is not None:
          with maybe_span(tel, "cache_lookup", round=k):
            t_c = clock()
            if windows is not None:
                scales = [max(e / rcfg.traffic.rate, 1e-6)
                          for e in est_rates]
            elif rcfg.traffic is not None:
                scales = [max(float(ev.load_scale), 1e-6)] * len(dags)
            else:
                scales = [1.0] * len(dags)
            keys_k = [cache.key(fps[i], env_k, scales[i])
                      for i in range(len(dags))]
            cached_plans = cache.lookup_fleet(keys_k, probs)
            cache_wall = clock() - t_c
            cached_plans, cache_wall = agree(mesh,
                                             (cached_plans, cache_wall))
            cache_hit = cached_plans is not None
          if tel is not None:
            tel.instant("cache_hit" if cache_hit else "cache_miss",
                        round=k)
            tel.observe("service.cache_lookup_s", cache_wall)

        rejected = 0
        arrivals = None
        if not cache_hit:
            if windows is not None:
                tc = rcfg.traffic
                arrivals = [tc.solver_arrivals(
                    dags[i].num_apps, seed=seed + 1000 * k + 31 * i,
                    rate_scale=max(est_rates[i] / tc.rate, 1e-6))
                    for i in range(len(dags))]
            else:
                arrivals = _round_arrivals(rcfg, dags, ev,
                                           seed + 1000 * k)
            arrivals, rejected = _triage(dags, probs, env_k,
                                         cfg.triage_margin, arrivals)
        _bump("rejected_apps", rejected)
        if tel is not None and rejected:
            tel.instant("triage_reject", round=k, apps=rejected)

        # watchdog: remaining SLO slack → iteration budget → rung.
        # (iter_est, NOT the rate estimate: per-iteration solve seconds.)
        iter_est = per_iter.value
        budget = float("inf") \
            if iter_est is None or not np.isfinite(cfg.slo_s) \
            else cfg.slo_s / max(iter_est, 1e-12)
        breaker_state = breaker.state
        want: Optional[ReplanConfig] = None
        if cache_hit:
            rung0 = "cached"
        else:
            rung0 = _select_rung(budget, rcfg.pso.max_iters,
                                 cfg.burst.max_iters)
            want = {"warm": rcfg, "burst": burst_rcfg,
                    "pinned": None}[rung0]
            if rung0 != "warm":
                _bump("watchdog_cuts")
                if tel is not None:
                    tel.instant("watchdog_cut", round=k, rung=rung0,
                                budget_iters=min(budget, 1e18))
            if not breaker.allow(k):
                want, rung0 = None, "pinned"
                if tel is not None:
                    tel.instant("breaker_pinned", round=k)

        solver_failed = False
        retries_used = 0
        rlog: Optional[RoundLog] = None
        new_plans: Optional[List[np.ndarray]] = cached_plans
        t0 = clock()
        if want is not None:
            def attempt(a: int, _want=want):
                nonlocal retries_used
                retries_used = a
                if injector is not None:
                    injector.maybe_fail(k)
                return replan_round(probs, plans, _want, seed=seed + k,
                                    round_no=k, label=ev.label,
                                    arrivals=arrivals, device=device,
                                    telemetry=tel)
            try:
                with maybe_span(tel, "solve", round=k, rung=rung0):
                    new_plans, rlog = retry_with_backoff(
                        attempt, retries=cfg.retries,
                        backoff_s=cfg.backoff_s, sleeper=sleeper)
            except SimulatedFailure:
                solver_failed = True
                _bump("crashes")
                if tel is not None:
                    tel.instant("solver_crash", round=k,
                                retries=retries_used)
            _bump("retries", retries_used)
        wall = clock() - t0
        if cache_hit:
            # time-to-plan for a cached round is the lookup+revalidation
            # time; injected solver stalls can't stall a skipped solve.
            wall = cache_wall
        elif cfg.chaos is not None and k in cfg.chaos.stall_rounds:
            wall += cfg.chaos.stall_s
        wall = agree(mesh, wall)
        if tel is not None:
            tel.observe("service.round_wall_s", wall)
        stalled = False
        if want is not None:
            stalled = detector.update(wall)
            if stalled:
                _bump("stalls_flagged")
                if tel is not None:
                    tel.instant("stall_flagged", round=k, wall_s=wall)
                if cfg.treat_stalls_as_failures:
                    solver_failed = True
                    new_plans, rlog = None, None
        if want is not None and not solver_failed:
            breaker.record_success()
            if rlog is not None:
                it_max = int(np.max(rlog.iterations, initial=1))
                per_iter.update(wall / max(it_max, 1))
            _bump("demotions", int(np.sum(rlog.demoted))
                  if rlog is not None else 0)
        elif want is not None:
            opened = breaker.opened
            breaker.record_failure(k)
            _bump("breaker_opened", breaker.opened - opened)
            if tel is not None and breaker.opened > opened:
                tel.instant("breaker_opened", round=k)

        # mid-round churn: the environment the plans must RUN on.
        probs_post, env_post = probs, env_k
        if cfg.chaos is not None and k in cfg.chaos.mid_round_down:
            env_post = _down_env(env_k, cfg.chaos.mid_round_down[k])
            probs_post = [SimProblem.build(d, env_post) for d in dags]
            if tel is not None:
                tel.instant("mid_round_down", round=k,
                            server=cfg.chaos.mid_round_down[k])

        # the ladder: promote each problem's best available plan.
        rung: List[str] = []
        with maybe_span(tel, "ladder", round=k):
            for i, (d, pr) in enumerate(zip(dags, probs_post)):
                if new_plans is not None:
                    cand, r_i = new_plans[i], rung0
                else:
                    cand, r_i = plans[i], "pinned"
                if _plan_ok(pr, cand):
                    plans[i] = np.asarray(cand, np.int32)
                else:
                    r_i, cand = _ladder_tail(d, pr, env_post,
                                             rcfg.pso.faithful_sim)
                    plans[i] = cand
                    if tel is not None:
                        tel.instant("ladder_demote", round=k,
                                    problem=i, rung=r_i)
                rung.append(r_i)
                fallback_counts[r_i] += 1
                if tel is not None:
                    tel.inc(f"service.rung.{r_i}")

        # store freshly-solved plans for repeat scenarios: only solver
        # rungs (accepted under env_k with their replay invariants) and
        # only when no mid-round churn separated solve-env from
        # serve-env — a post-churn plan belongs to an env the key never
        # saw.
        if (cache is not None and not cache_hit
                and env_post is env_k):
            for i, r_i in enumerate(rung):
                if r_i in ("warm", "burst") and plans[i] is not None:
                    cache.store(keys_k[i], probs[i], plans[i])

        if tel is not None:
            tel.set_gauge("service.breaker_open",
                          0.0 if breaker_state == "closed" else 1.0)
        rounds.append(ServiceRoundLog(
            round=k, label=ev.label, rung=tuple(rung), wall_s=wall,
            budget_iters=budget, breaker_state=breaker_state,
            solver_failed=solver_failed, retries_used=retries_used,
            stale_env=stale_env, stalled=stalled,
            rejected_apps=rejected, est_rates=est_rates,
            replan=rlog, cache_hit=cache_hit))
        if on_round is not None:
            on_round(rounds[-1], plans)

    if producers:
        stop.set()
        for th in producers:
            th.join()
    if queue is not None:
        qc = queue.counters()
        counters["ingest_enqueued"] = qc["enqueued"]
        counters["ingest_dropped"] = qc["dropped"]
        counters["ingest_drained"] = qc["drained"]
        counters["ingest_leftover"] = qc["depth"]

    if tel is not None:
        # final snapshot stamps: the service.* counters were kept in
        # sync live by _bump (except the ingest_* totals, owned by the
        # queue and finalized just above); plancache.* counters catch up
        # to ``cache.stats()`` — a no-op for a cache this service built
        # (live-mirrored), the missing delta for a shared external cache
        # constructed without telemetry — so ONE export carries
        # everything the report does (DESIGN.md §13). The reference's
        # runner_cache.* gauges have no counterpart in the port.
        for nm in ("ingest_enqueued", "ingest_dropped",
                   "ingest_drained", "ingest_leftover"):
            c = tel.registry.counter(f"service.{nm}")
            c.inc(counters[nm] - c.value)
        if cache is not None:
            for nm, v in cache.stats().items():
                c = tel.registry.counter(f"plancache.{nm}")
                c.inc(max(0, v - c.value))

    return ServiceReport(cold=cold, rounds=rounds, plans=plans,
                         fallback_counts=fallback_counts,
                         counters=counters,
                         cache_stats=cache.stats() if cache is not None
                         else None)


def run_services(fleets: Sequence[Sequence[LayerDAG]],
                 traces: Union[EnvTrace, Sequence[EnvTrace]],
                 cfgs: Union[ServiceConfig, Sequence[ServiceConfig],
                             None] = None,
                 seeds: Union[int, Sequence[int]] = 0,
                 plan_cache: Optional[PlanCache] = None,
                 max_workers: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> List[ServiceReport]:
    """Run N planning services concurrently on one device (``None`` = the
    card).

    Each fleet gets its own ``run_service`` loop on its own thread; all
    of them launch B1 and B2 on the same card through the locked replay
    wrappers (DESIGN.md §11 phase 2) — and, since each loop's solves are
    seeded and self-contained, every service's report is bit-identical
    to running it alone. ``traces`` / ``cfgs`` / ``seeds``
    broadcast: pass one value for all services or a sequence of
    ``len(fleets)``. An optional shared ``plan_cache`` lets services
    reuse each other's solves (its stats then aggregate all of them).
    A shared ``telemetry`` (DESIGN.md §13) gives service ``j`` its own
    Perfetto track (tid ``j``, labeled ``service-j``): the registry and
    tracer are thread-safe, so the N loops interleave into one timeline.
    A meshed config (``replan.mesh``) is served over a world of one rank
    only: the loops' collectives are serialised per process
    (``launch.mesh``), which orders them on one rank but not across ranks.
    """
    n = len(fleets)
    if n == 0:
        return []

    def _bcast(x, name):
        if isinstance(x, (list, tuple)):
            if len(x) != n:
                raise ValueError(f"{len(x)} {name} for {n} fleets")
            return list(x)
        return [x] * n

    traces_l = _bcast(traces, "traces")
    cfgs_l = _bcast(cfgs if cfgs is not None else ServiceConfig(),
                    "configs")
    seeds_l = _bcast(seeds, "seeds")
    if n > 1 and any(c.replan.mesh is not None for c in cfgs_l):
        import torch.distributed as dist
        if dist.get_world_size() > 1:
            raise ValueError(
                "run_services runs its services' meshed solves on threads "
                "of one process: over more than one rank their collectives "
                "could pair up out of order across ranks; run one meshed "
                "service per process, or the mesh over a world of one")
    with ThreadPoolExecutor(max_workers=max_workers or n) as ex:
        futs = [ex.submit(run_service, fleets[j], traces_l[j],
                          cfgs_l[j], seed=seeds_l[j],
                          plan_cache=plan_cache, telemetry=telemetry,
                          track=j if telemetry is not None else None,
                          device=device)
                for j in range(n)]
        return [f.result() for f in futs]
