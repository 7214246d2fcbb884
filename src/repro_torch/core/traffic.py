"""Request-stream workload engine: score offloading plans under
concurrent load (DESIGN.md §10), ported from ``repro.core.traffic``.

  * **Arrival traces** — ``ArrivalTrace``, ``sample_arrivals`` and
    ``TrafficConfig``: numpy, copied from the reference, so the port draws
    the very same request timestamps from the same seeds.
  * **Queue-aware replay** — R request copies of every particle's
    schedule against shared per-server FCFS queues, in the merged order
    (requests in arrival order, then request slot, layers in topo order
    within a request). ``merged_order`` sorts the steps once per arrival
    draw with padding compacted to the tail; ``traffic_inputs`` packs it
    for the replay, which runs the hand-written kernel on CUDA tensors and
    its plain PyTorch version on CPU tensors
    (``kernels/traffic_sim.py``). ``simulate_traffic_swarm`` replays a
    swarm; a zero-contention trace (1 request/app at t = 0) reproduces the
    single-shot replay bit for bit.
  * **Contention metrics** — per-request latencies, deadline-miss rate
    and the load-adjusted Eq. 8 cost of the whole horizon;
    ``traffic_replay`` replays one plan under Monte-Carlo draws and
    ``traffic_stats`` summarises the tails (p50/p95/p99).

Queueing discipline: each server serves work in request-arrival order —
all layers of an earlier-arriving request precede every layer of a later
one, with head-of-line blocking. Same-app arrival ties serve in slot
order, cross-app ties interleave by topo position. The order depends on
the arrivals only, so it is built once per draw, not once per replay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..kernels.traffic_sim import traffic_replay as _replay
from .device import resolve_device
from .seeding import rng_entropy
from .simulator import PaddedProblem, SimProblem, kernel_args, pad_problem

__all__ = ["TRAFFIC_KINDS", "ArrivalTrace", "TrafficConfig",
           "sample_arrivals", "zero_contention_arrivals", "MergedOrder",
           "merged_order", "TrafficInputs", "traffic_inputs",
           "percentile_linear", "TrafficSim", "simulate_traffic_swarm",
           "TrafficResult", "traffic_replay", "traffic_stats"]

TRAFFIC_KINDS = ("poisson", "diurnal", "bursty", "flash-crowd")


def _require_positive_finite(name: str, value: float) -> float:
    """Front-door validation (DESIGN.md §11): a NaN or non-positive rate
    fed to the generators would silently propagate into the fitness
    (NaN keys freeze PSO's argmin; rate 0 makes every replay vacuously
    feasible) — reject loudly at the boundary instead."""
    v = float(value)
    if not np.isfinite(v) or v <= 0.0:
        raise ValueError(f"{name} must be a positive finite number, "
                         f"got {value!r}")
    return v


def _require_count(name: str, value: int, minimum: int = 1) -> int:
    v = int(value)
    if v < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value!r}")
    return v


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """Per-app request timestamps over ``[0, horizon)``.

    ``t`` is ``(n_seeds, n_apps, max_requests)`` float64, ascending per
    app, padded with +inf — a slot of +inf means "no such request", and
    the replay engine never walks it, so every seed and every load level
    shares ONE array shape. Requests beyond ``max_requests`` in a draw are
    dropped (the cap is part of the workload model, like a front-door
    admission limit).
    """
    kind: str
    rate: float                   # mean requests/s per app
    horizon: float                # seconds
    t: np.ndarray                 # (n_seeds, n_apps, max_requests)

    @property
    def n_seeds(self) -> int:
        return int(self.t.shape[0])

    @property
    def n_apps(self) -> int:
        return int(self.t.shape[1])

    @property
    def max_requests(self) -> int:
        return int(self.t.shape[2])

    def counts(self) -> np.ndarray:
        """(n_seeds, n_apps) number of real requests per app."""
        return np.isfinite(self.t).sum(axis=2)


def _draw_poisson(rng: np.random.Generator, rate: float,
                  horizon: float) -> List[float]:
    out: List[float] = []
    if rate <= 0.0:
        return out
    t = float(rng.exponential(1.0 / rate))
    while t < horizon:
        out.append(t)
        t += float(rng.exponential(1.0 / rate))
    return out


def _draw_thinned(rng: np.random.Generator, lam: Callable[[float], float],
                  lam_max: float, horizon: float) -> List[float]:
    """Inhomogeneous Poisson via Lewis-Shedler thinning."""
    out: List[float] = []
    if lam_max <= 0.0:
        return out
    t = float(rng.exponential(1.0 / lam_max))
    while t < horizon:
        if rng.uniform() * lam_max <= lam(t):
            out.append(t)
        t += float(rng.exponential(1.0 / lam_max))
    return out


def _mmpp_intervals(rng: np.random.Generator, horizon: float
                    ) -> List[tuple]:
    """Two-state Markov-modulated intervals (start, end, high?) shared
    by every app of the seed — bursts are correlated across apps, which
    is exactly what makes them hard on a shared server."""
    out = []
    t, high = 0.0, False
    while t < horizon:
        dwell = float(rng.exponential(horizon / (8.0 if high else 4.0)))
        out.append((t, min(t + dwell, horizon), high))
        t += dwell
        high = not high
    return out


def sample_arrivals(kind: str, n_apps: int, rate: float = 0.5,
                    horizon: float = 30.0, max_requests: int = 8,
                    n_seeds: int = 1, seed: int = 0) -> ArrivalTrace:
    """Generate a fixed-shape arrival trace for one scenario family.

    ``poisson``     — homogeneous rate ``rate``, independent per app.
    ``diurnal``     — sinusoidal intensity ``rate·(1 + 0.9·sin)`` with
                      the peak mid-horizon (a compressed day).
    ``bursty``      — 2-state MMPP: λ_low = 0.3·rate, λ_high = 2.4·rate,
                      dwell means horizon/4 and horizon/8; the state
                      path is SHARED across apps (correlated bursts).
    ``flash-crowd`` — 0.5·rate baseline plus a ×4·rate crowd window of
                      0.15·horizon at a random onset, shared across
                      apps (everyone arrives at once).

    Mean intensity is ≈ ``rate`` requests/s/app for every family, so an
    intensity sweep compares like with like. Seeded and deterministic:
    seed index ``s`` draws from ``default_rng([seed, s])``; the seed is
    routed through the fleet solver's int-coercion front door, so numpy
    integer scalars, 0-d arrays, and negative seeds all work.
    """
    if kind not in TRAFFIC_KINDS:
        raise ValueError(f"unknown traffic kind {kind!r} "
                         f"(expected one of {TRAFFIC_KINDS})")
    rate = _require_positive_finite("rate", rate)
    horizon = _require_positive_finite("horizon", horizon)
    n_apps = _require_count("n_apps", n_apps)
    max_requests = _require_count("max_requests", max_requests)
    n_seeds = _require_count("n_seeds", n_seeds)
    entropy = rng_entropy(seed)
    t = np.full((n_seeds, n_apps, max_requests), np.inf)
    for s in range(n_seeds):
        rng = np.random.default_rng([entropy, s])
        if kind == "bursty":
            ivals = _mmpp_intervals(rng, horizon)

            def lam(x: float) -> float:
                for lo, hi, high in ivals:
                    if lo <= x < hi:
                        return (2.4 if high else 0.3) * rate
                return 0.3 * rate
            lam_max = 2.4 * rate
        elif kind == "flash-crowd":
            t0 = float(rng.uniform(0.2, 0.6)) * horizon
            w = 0.15 * horizon

            def lam(x: float) -> float:
                return 0.5 * rate + (4.0 * rate if t0 <= x < t0 + w
                                     else 0.0)
            lam_max = 4.5 * rate
        elif kind == "diurnal":
            def lam(x: float) -> float:
                return rate * (1.0 + 0.9 * np.sin(
                    2.0 * np.pi * x / horizon - np.pi / 2.0))
            lam_max = 1.9 * rate
        else:
            lam, lam_max = None, rate
        for a in range(n_apps):
            if kind == "poisson":
                times = _draw_poisson(rng, rate, horizon)
            else:
                times = _draw_thinned(rng, lam, lam_max, horizon)
            times = times[:max_requests]
            t[s, a, :len(times)] = times
    return ArrivalTrace(kind=kind, rate=rate, horizon=horizon, t=t)


def zero_contention_arrivals(n_apps: int, n_seeds: int = 1) -> np.ndarray:
    """(n_seeds, n_apps, 1) — one request per app at t = 0: the replay
    then reproduces the single-shot simulator bit-for-bit (tested)."""
    return np.zeros((n_seeds, n_apps, 1))


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One knob bundle for every traffic consumer (solver fitness, the
    online re-planner, ``serve --plan --traffic`` and the benchmark).

    ``mc_solver`` arrival seeds flow into the contention-aware fitness
    (small: every PSO-GA iteration replays all of them); ``mc_eval``
    seeds are the reporting/evaluation set (larger, drawn from a
    disjoint seed stream so plans are never scored on the arrivals
    they were optimized against). ``miss_budget`` is the p95
    deadline-miss budget the solver must satisfy (DESIGN.md §10).
    """
    kind: str = "poisson"
    rate: float = 0.5
    horizon: float = 30.0
    max_requests: int = 8
    mc_solver: int = 3
    mc_eval: int = 16
    miss_budget: float = 0.05

    def __post_init__(self):
        if self.kind not in TRAFFIC_KINDS:
            raise ValueError(f"unknown traffic kind {self.kind!r} "
                             f"(expected one of {TRAFFIC_KINDS})")
        _require_positive_finite("rate", self.rate)
        _require_positive_finite("horizon", self.horizon)
        _require_count("max_requests", self.max_requests)
        _require_count("mc_solver", self.mc_solver)
        _require_count("mc_eval", self.mc_eval)
        mb = float(self.miss_budget)
        if not np.isfinite(mb) or not 0.0 <= mb <= 1.0:
            raise ValueError(f"miss_budget must be in [0, 1], "
                             f"got {self.miss_budget!r}")

    def solver_arrivals(self, n_apps: int, seed: int = 0,
                        rate_scale: float = 1.0) -> np.ndarray:
        """(mc_solver, n_apps, max_requests) solver-side arrival draws."""
        return sample_arrivals(
            self.kind, n_apps, rate=self.rate * rate_scale,
            horizon=self.horizon, max_requests=self.max_requests,
            n_seeds=self.mc_solver, seed=seed).t

    def eval_arrivals(self, n_apps: int, seed: int = 0,
                      rate_scale: float = 1.0) -> np.ndarray:
        """(mc_eval, n_apps, max_requests) held-out evaluation draws."""
        return sample_arrivals(
            self.kind, n_apps, rate=self.rate * rate_scale,
            horizon=self.horizon, max_requests=self.max_requests,
            n_seeds=self.mc_eval, seed=seed + 104729).t


# ---------------------------------------------------------------------------
# queue-aware replay: the merged order, built once per arrival draw
# ---------------------------------------------------------------------------


def _arrivals_f32(arr, device: torch.device) -> torch.Tensor:
    """Arrival times as float32 on ``device``. The cast comes before any
    sort, as the reference's: two float64 times that round to one float32
    value become a tie, broken by (request slot, topo position)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(arr, np.float32), device=device)


class MergedOrder(NamedTuple):
    """The merged event order of one or more arrival draws over R request
    copies; step axis T = R·max_p last, real steps first."""
    t_m: torch.Tensor         # (..., T) topo position of each step
    r_m: torch.Tensor         # (..., T) request slot of each step
    key_m: torch.Tensor       # (..., T) f32 arrival (+inf when not real)
    valid_m: torch.Tensor     # (..., T) bool real step
    n_valid: torch.Tensor     # (...,) i32 real steps
    slot_m: torch.Tensor      # (..., T) i32 end slot r·max_p + layer id
    arr_m: torch.Tensor       # (..., T) f32 arrival, 0 when not real


def _merged(order: torch.Tensor, app_id: torch.Tensor,
            arr: torch.Tensor) -> MergedOrder:
    """``order, app_id (N, max_p)``, ``arr (N, M, max_apps, R)`` f32."""
    N, L = order.shape
    M, _, R = arr.shape[1:]
    valid = order >= 0
    jsafe = torch.where(valid, order, 0).long()
    app = app_id.long().gather(1, jsafe)                     # (N, L)
    key = arr.gather(2, app[:, None, :, None].expand(N, M, L, R))
    key = torch.where(valid[:, None, :, None], key, float("inf"))
    # flat step index r·L + t: a stable sort on the key alone breaks ties
    # by (request slot, topo position), the reference's lexsort order
    key = key.transpose(2, 3).reshape(N, M, R * L)
    key_m, perm = torch.sort(key, dim=-1, stable=True)
    t_m, r_m = perm % L, perm // L
    valid_m = torch.isfinite(key_m)
    slot_m = r_m * L + jsafe.gather(1, t_m.reshape(N, -1)).reshape(t_m.shape)
    return MergedOrder(
        t_m=t_m, r_m=r_m, key_m=key_m, valid_m=valid_m,
        n_valid=valid_m.sum(-1).to(torch.int32),
        slot_m=slot_m.to(torch.int32),
        arr_m=torch.where(valid_m, key_m, 0.0))


def merged_order(pp: PaddedProblem, arr) -> MergedOrder:
    """The merged order of one arrival draw ``arr (max_apps, R)`` on a
    single padded problem (the reference's ``_merged_order``).

    Sort key (stable): request arrival time, then request slot, then topo
    position. Padded-layer steps take the key +inf and join the +inf
    (padded) request slots past every real step, so the real steps form a
    prefix of length ``n_valid`` in their exact order."""
    a = _arrivals_f32(arr, pp.device)
    mo = _merged(pp.order[None], pp.app_id[None], a[None, None])
    return MergedOrder(*(t[0, 0] for t in mo))


class TrafficInputs(NamedTuple):
    """The merged-order arguments of ``kernels.traffic_sim.traffic_replay``
    for a fleet of problems and M draws each."""
    slot_m: torch.Tensor      # (N, M, T) i32
    arr_m: torch.Tensor       # (N, M, T) f32
    n_valid: torch.Tensor     # (N, M) i32
    arr2: torch.Tensor        # (N, M, max_apps, R) f32, 0 when not real
    req_valid: torch.Tensor   # (N, M, max_apps, R) bool


def traffic_inputs(pp: PaddedProblem, arr) -> TrafficInputs:
    """Merged orders and request masks of the draws ``arr``: ``(M,
    max_apps, R)`` for one problem, ``(N, M, max_apps, R)`` for a stacked
    fleet. A request is real when its time is finite and its app is one of
    the problem's true apps."""
    a = _arrivals_f32(arr, pp.device)
    if a.dim() != (4 if pp.stacked else 3) \
            or a.shape[-2] != pp.deadline.shape[-1]:
        raise ValueError(
            f"arrivals have shape {tuple(a.shape)}; expected "
            f"({'N, ' if pp.stacked else ''}M, max_apps="
            f"{pp.deadline.shape[-1]}, R) for this problem")
    order, app_id = pp.order, pp.app_id
    num_apps = pp.num_apps.reshape(-1)
    if not pp.stacked:
        a, order, app_id = a[None], order[None], app_id[None]
    mo = _merged(order, app_id, a)
    app_real = torch.arange(a.shape[2], device=pp.device) < num_apps[:, None]
    rv = torch.isfinite(a) & app_real[:, None, :, None]
    return TrafficInputs(slot_m=mo.slot_m, arr_m=mo.arr_m,
                         n_valid=mo.n_valid,
                         arr2=torch.where(rv, a, 0.0).contiguous(),
                         req_valid=rv.contiguous())


def percentile_linear(x: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=dim)`` (linear interpolation) bit for
    bit as the reference's solver runs it, inside ``jit``: sort, then
    ``low·(1−h) + high·h`` at the position ``(q·0.01)·(n−1)`` in float32.
    Under ``jit`` XLA folds the literal ``q/100`` into ``q·0.01`` first
    (an eager call rounds ``q·(0.01·(n−1))`` instead, which differs in
    the last ulp for some n), and compiles the sum to one fused
    multiply-add, emulated here in float64 (the float32 product is exact
    there)."""
    f32 = np.float32
    n = x.shape[dim]
    pos = (f32(q) * f32(0.01)) * f32(n - 1)
    low, high = min(max(int(np.floor(pos)), 0), n - 1), \
        min(max(int(np.ceil(pos)), 0), n - 1)
    hw = pos - f32(low)
    lw = f32(1.0) - hw
    xs = torch.sort(x, dim=dim).values
    hi_part = xs.select(dim, high) * float(hw)     # a float32 multiply
    return (xs.select(dim, low).double() * float(lw)
            + hi_part.double()).float()


class TrafficSim(NamedTuple):
    """A swarm replayed under arrival draws. Leading axes: (P,) for one
    problem and one draw, (M, P) for M draws, (N, M, P) for a stacked
    fleet; ``static_ok`` and ``req_valid`` carry no particle axis or no
    draw axis where they do not depend on it."""
    latency: torch.Tensor     # (..., P, max_apps, R) completion − arrival
    miss: torch.Tensor        # (..., P, max_apps, R) bool deadline miss
    req_valid: torch.Tensor   # (..., max_apps, R) bool real request slot
    miss_rate: torch.Tensor   # (..., P) missed / real requests
    total_cost: torch.Tensor  # (..., P) load-adjusted Eq. 8
    lat_sum: torch.Tensor     # (..., P) Σ real latencies (Eq. 16 analogue)
    static_ok: torch.Tensor   # (P,) or (N, P) bool: pins honored, links legal


#: the draw axis of each per-draw ``TrafficSim`` field
_DRAW_DIM = {"latency": -4, "miss": -4, "req_valid": -3, "miss_rate": -2,
             "total_cost": -2, "lat_sum": -2}


def simulate_traffic_swarm(pp: PaddedProblem, X: torch.Tensor, arr,
                           faithful: bool = True) -> TrafficSim:
    """Replay R request copies of every particle's schedule against shared
    per-server FCFS queues:

        faithful:  start = max(lease[s], a_r) + maxTrans
                   lease[s] = max(lease[s], a_r) + exe + transfer_out
        corrected: start = max(lease[s], a_r, max_p(end[r,p] + trans_p))
                   lease[s] = start + exe + transfer_out

    ``X (P, max_p)`` with ``arr (max_apps, R)`` (one draw) or ``(M,
    max_apps, R)``; on a stacked ``pp``, ``X (N, P, max_p)`` with ``arr
    (N, M, max_apps, R)``. The walk covers only the real steps of the
    merged order (the reference's ``compact=True`` mode; its full walk is
    the same replay). CUDA tensors run the kernel, CPU tensors its plain
    version. At R = 1 with arrival 0 both modes reduce bit for bit to the
    single-shot replay."""
    a = _arrivals_f32(arr, pp.device)
    one_draw = a.dim() == (3 if pp.stacked else 2)
    if one_draw:
        a = a.unsqueeze(-3)
    X = torch.as_tensor(X, device=pp.device).to(torch.int32).contiguous()
    tin = traffic_inputs(pp, a)
    X3 = X if pp.stacked else X[None]
    (N, P), (M, A, R) = X3.shape[:2], a.shape[-3:]
    buf = torch.empty((N, M, P, A, R), dtype=torch.float32, device=pp.device)
    total, miss_rate, lat_sum, static_ok, latency = _replay(
        *kernel_args(pp), X3, *tin, faithful=faithful, latency=buf)
    dl = pp.deadline if pp.stacked else pp.deadline[None]
    miss = tin.req_valid[:, :, None] & (latency > dl[:, None, None, :, None])
    sim = TrafficSim(latency=latency, miss=miss, req_valid=tin.req_valid,
                     miss_rate=miss_rate, total_cost=total, lat_sum=lat_sum,
                     static_ok=static_ok)
    if not pp.stacked:
        sim = TrafficSim(*(t[0] for t in sim))
    if one_draw:
        sim = sim._replace(**{f: getattr(sim, f).select(d, 0)
                              for f, d in _DRAW_DIM.items()})
    return sim


# ---------------------------------------------------------------------------
# Monte-Carlo evaluation of ONE plan
# ---------------------------------------------------------------------------


class TrafficResult(NamedTuple):
    """Monte-Carlo replay of one plan. Leading axis = arrival seed."""
    latency: np.ndarray       # (M, max_apps, R)
    miss: np.ndarray          # (M, max_apps, R) bool
    req_valid: np.ndarray     # (M, max_apps, R) bool
    miss_rate: np.ndarray     # (M,)
    total_cost: np.ndarray    # (M,)
    feasible: bool            # static: pins honored, links legal


def traffic_replay(prob: Union[SimProblem, PaddedProblem], x: np.ndarray,
                   arrivals: np.ndarray, faithful: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> TrafficResult:
    """Replay one plan against Monte-Carlo arrival draws on ``device``
    (``None`` = the card; a ``PaddedProblem`` keeps its own device).

    ``arrivals``: ``(M, n_apps, R)`` (or ``(n_apps, R)`` for one draw)
    timestamps, +inf padded — e.g. ``ArrivalTrace.t`` or
    ``TrafficConfig.eval_arrivals``. Returns per-seed/per-request
    latencies, deadline misses, and load-adjusted costs; feed the result
    to ``traffic_stats`` for p50/p95/p99 tails."""
    pp = prob if isinstance(prob, PaddedProblem) \
        else pad_problem(prob, device=resolve_device(device))
    max_p, max_apps = pp.max_layers, int(pp.deadline.shape[-1])
    x = np.asarray(x, np.int32)
    X1 = np.zeros((1, max_p), np.int32)
    X1[0, :x.shape[0]] = x
    arr = np.asarray(arrivals, float)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.shape[1] < max_apps:                 # pad apps with +inf slots
        pad = np.full((arr.shape[0], max_apps - arr.shape[1],
                       arr.shape[2]), np.inf)
        arr = np.concatenate([arr, pad], axis=1)
    sims = simulate_traffic_swarm(pp, torch.as_tensor(X1, device=pp.device),
                                  arr, faithful)
    host = lambda t: t.cpu().numpy()
    return TrafficResult(
        latency=host(sims.latency)[:, 0], miss=host(sims.miss)[:, 0],
        req_valid=host(sims.req_valid), miss_rate=host(sims.miss_rate)[:, 0],
        total_cost=host(sims.total_cost)[:, 0],
        feasible=bool(sims.static_ok[0]))


def traffic_stats(res: TrafficResult) -> dict:
    """Tail summary of a Monte-Carlo replay (numbers for reports)."""
    mr = np.asarray(res.miss_rate, float)
    out = {
        "miss_mean": float(mr.mean()),
        "miss_p50": float(np.percentile(mr, 50)),
        "miss_p95": float(np.percentile(mr, 95)),
        "miss_p99": float(np.percentile(mr, 99)),
        "cost_mean": float(np.asarray(res.total_cost).mean()),
        "requests": int(res.req_valid.sum()),
        "feasible": bool(res.feasible),
    }
    lat = res.latency[res.req_valid]
    out["latency_p95"] = float(np.percentile(lat, 95)) if lat.size else 0.0
    return out
