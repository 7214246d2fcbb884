"""Unified telemetry layer: metrics registry + span tracer (DESIGN.md §13),
a copy of ``repro.core.telemetry`` (numpy, threading and a profiler
range), so the same operations under the same clock export byte-equal
JSONL, Prometheus text and Chrome traces in both packages.

The planning-service stack produces all the signal an operator needs —
per-round time-to-plan, cache hit rates, ladder rung mix, solver
convergence curves, ingestion backpressure — and this module is the ONE
pipeline from event to export (``ServiceReport.counters``,
``PlanCache.stats()`` and ``ArrivalQueue.counters()`` mirror onto it):

  * **MetricsRegistry** — counters (monotonic), gauges (last value),
    bounded-reservoir histograms (exact count/sum/min/max, sampled
    p50/p95/p99), and timestamped series (the solver's gBest curve).
    Thread-safe (one lock, every op O(1)), injectable clock so tests
    assert on timings deterministically, snapshot exporters to JSONL
    and Prometheus text exposition format.
  * **SpanTracer** — ``with tracer.span("replan_round", round=k)``
    emits Chrome trace-event JSON (``ph``/``ts``/``pid``/``tid``/
    ``name``) loadable in Perfetto or ``chrome://tracing``. Spans are
    B/E pairs on per-service tracks (``set_track``), point events are
    instants; nesting follows the with-statement, so a round span
    contains its cache-lookup, solve, and ladder children.
  * **Telemetry** — the facade bundling one registry + one tracer on a
    shared clock; every producer in the stack takes an optional
    ``telemetry`` argument defaulting to ``None``. With it unset,
    every instrumented path takes a no-telemetry branch that is
    bit-identical to the pre-telemetry behavior (the off-parity
    invariant, tests/test_telemetry.py).

A process-global default (``set_telemetry`` / ``get_telemetry`` /
``telemetry_scope``) lets deep layers that have no config path — the
fleet solver's ``fleet_solve`` spans, ``run_pso_ga``'s history recorder,
the serving path's Mamba2 blocks and SSD phases — emit into the
process's telemetry without threading an argument through every call
site. The global is a convenience channel: explicit arguments always
win, and ``run_service`` never mutates it. The
reference's ``runner_cache.*`` metrics count JAX's compiled fleet
runners; the port compiles nothing per shape and has none.

One addition to the reference's: while ``torch.profiler`` runs, every
span also opens a ``torch.profiler.record_function`` range of its name,
so the program's spans sit in the kineto trace on the device operations'
clock (a device operation belongs to the innermost span open when it was
launched). Without a profiler no range is opened (it would record
nothing and cost as much as the span); the B/E events, and so every
export, are the reference's.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["Counter", "Gauge", "Histogram", "Series", "MetricsRegistry",
           "SpanTracer", "Telemetry", "get_telemetry", "set_telemetry",
           "telemetry_scope", "maybe_span"]

#: reservoir size of a Histogram unless overridden — large enough that
#: p99 over a service run is stable, small enough that a hot path never
#: grows without bound.
DEFAULT_RESERVOIR = 512

#: points a Series keeps (FIFO once full) — a gBest curve is max_iters
#: long (≤ a few hundred), so full solves fit; runaway producers don't.
DEFAULT_SERIES_POINTS = 4096


class Counter:
    """Monotonic counter. ``inc`` only — decrements are a gauge's job."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc {n!r}); use a gauge")
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value-wins gauge."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, quantiles
    estimated from a fixed-size uniform sample (Vitter's algorithm R,
    seeded per metric name so two identical runs sample identically).
    """

    __slots__ = ("name", "_res", "_size", "_count", "_sum", "_min",
                 "_max", "_rng", "_lock")

    def __init__(self, name: str,
                 reservoir: int = DEFAULT_RESERVOIR) -> None:
        if int(reservoir) < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir!r}")
        self.name = name
        self._res: List[float] = []
        self._size = int(reservoir)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        # deterministic per-name seed: parity runs sample identically
        self._rng = np.random.default_rng(
            np.frombuffer(name.encode()[:32].ljust(32, b"\0"), np.uint64))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._res) < self._size:
                self._res.append(v)
            else:
                j = int(self._rng.integers(self._count))
                if j < self._size:
                    self._res[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        """q ∈ [0, 100]: percentile over the reservoir (0.0 if empty)."""
        with self._lock:
            if not self._res:
                return 0.0
            return float(np.percentile(self._res, q))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0}
            res = np.asarray(self._res)
            p50, p95, p99 = np.percentile(res, [50, 95, 99])
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "p50": float(p50), "p95": float(p95),
                    "p99": float(p99)}


class Series:
    """Bounded timestamped value stream (e.g. the solver's per-iteration
    gBest key). FIFO once full — the tail of a convergence curve is the
    interesting part."""

    __slots__ = ("name", "_t", "_v", "_maxlen", "_dropped", "_lock")

    def __init__(self, name: str,
                 max_points: int = DEFAULT_SERIES_POINTS) -> None:
        if int(max_points) < 1:
            raise ValueError(f"max_points must be >= 1, "
                             f"got {max_points!r}")
        self.name = name
        self._t: List[float] = []
        self._v: List[float] = []
        self._maxlen = int(max_points)
        self._dropped = 0
        self._lock = threading.Lock()

    def append(self, t: float, v: float) -> None:
        with self._lock:
            self._t.append(float(t))
            self._v.append(float(v))
            if len(self._v) > self._maxlen:
                del self._t[0], self._v[0]
                self._dropped += 1

    def extend(self, t0: float, values: Sequence[float]) -> None:
        """Append a whole curve at a common timestamp ``t0`` with the
        index as the sub-tick (one solve's history in one call)."""
        for i, v in enumerate(np.asarray(values, float).ravel()):
            self.append(t0 + i * 1e-9, float(v))

    def points(self) -> List[tuple]:
        with self._lock:
            return list(zip(self._t, self._v))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"n": len(self._v), "dropped": self._dropped,
                    "last": self._v[-1] if self._v else None}


def _prom_name(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:] only."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


class MetricsRegistry:
    """Name → metric registry with get-or-create accessors and snapshot
    exporters. All accessors are thread-safe; a name is bound to one
    metric kind for the registry's lifetime (re-registering it as
    another kind raises)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter
                 ) -> None:
        self.clock = clock
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} is a "
                                f"{type(m).__name__}, not a "
                                f"{kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get(name, Histogram, reservoir)

    def series(self, name: str,
               max_points: int = DEFAULT_SERIES_POINTS) -> Series:
        return self._get(name, Series, max_points)

    # -- convenience one-liners ---------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def record_series(self, name: str, values: Sequence[float]) -> None:
        self.series(name).extend(self.clock(), values)

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """One nested dict: {counters, gauges, histograms, series}."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}, "series": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.summary()
            else:
                out["series"][name] = m.summary()
        return out

    def to_jsonl(self) -> str:
        """One JSON object per line per metric — the machine-readable
        snapshot (series include their points)."""
        with self._lock:
            items = list(self._metrics.items())
        lines = []
        for name, m in items:
            if isinstance(m, Counter):
                rec = {"type": "counter", "name": name, "value": m.value}
            elif isinstance(m, Gauge):
                rec = {"type": "gauge", "name": name, "value": m.value}
            elif isinstance(m, Histogram):
                rec = {"type": "histogram", "name": name, **m.summary()}
            else:
                rec = {"type": "series", "name": name, **m.summary(),
                       "points": m.points()}
            lines.append(json.dumps(rec, allow_nan=False,
                                    default=float))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format: counters as ``_total``,
        histograms as summaries (quantile labels + _count/_sum), series
        as a last-value gauge."""
        with self._lock:
            items = list(self._metrics.items())
        out = []
        for name, m in items:
            pn = _prom_name(name)
            if isinstance(m, Counter):
                out.append(f"# TYPE {pn}_total counter")
                out.append(f"{pn}_total {m.value}")
            elif isinstance(m, Gauge):
                out.append(f"# TYPE {pn} gauge")
                out.append(f"{pn} {m.value}")
            elif isinstance(m, Histogram):
                s = m.summary()
                out.append(f"# TYPE {pn} summary")
                for q, key in ((0.5, "p50"), (0.95, "p95"),
                               (0.99, "p99")):
                    out.append(f'{pn}{{quantile="{q}"}} {s[key]}')
                out.append(f"{pn}_count {s['count']}")
                out.append(f"{pn}_sum {s['sum']}")
            else:
                s = m.summary()
                last = s["last"] if s["last"] is not None else 0.0
                out.append(f"# TYPE {pn}_last gauge")
                out.append(f"{pn}_last {last}")
        return "\n".join(out) + ("\n" if out else "")

    def write(self, out_dir: str) -> Dict[str, str]:
        """Write ``metrics.jsonl`` + ``metrics.prom`` under ``out_dir``
        (created if missing); returns the paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {"jsonl": os.path.join(out_dir, "metrics.jsonl"),
                 "prom": os.path.join(out_dir, "metrics.prom")}
        with open(paths["jsonl"], "w") as f:
            f.write(self.to_jsonl())
        with open(paths["prom"], "w") as f:
            f.write(self.to_prometheus())
        return paths


class SpanTracer:
    """Chrome-trace-event span recorder (Perfetto / chrome://tracing).

    Spans are emitted as ``B``/``E`` duration pairs, point events as
    ``i`` instants, and track labels as ``M`` metadata; every event
    carries the required ``ph``/``ts``/``pid``/``tid``/``name`` fields
    (``ts`` in microseconds on the tracer's clock, relative to tracer
    creation so traces start near 0). The current *track* (Perfetto
    row) is thread-local: ``set_track(j, "service-j")`` routes every
    span this thread opens onto track ``j`` — that is how N concurrent
    ``run_service`` loops get one timeline row each.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 pid: int = 0) -> None:
        self.clock = clock
        self.pid = int(pid)
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0 = clock()

    def _ts(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _tid(self, tid: Optional[int]) -> int:
        if tid is not None:
            return int(tid)
        return int(getattr(self._tls, "track", 0))

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def set_track(self, track: int, label: Optional[str] = None) -> None:
        """Route this thread's spans onto Perfetto row ``track``; with
        ``label``, also name the row (a ``thread_name`` metadata event).
        """
        self._tls.track = int(track)
        if label is not None:
            self._emit({"ph": "M", "ts": 0.0, "pid": self.pid,
                        "tid": int(track), "name": "thread_name",
                        "args": {"name": str(label)}})

    @contextlib.contextmanager
    def span(self, name: str, tid: Optional[int] = None,
             **args: Any) -> Iterator[None]:
        """``with tracer.span("replan_round", round=k): ...`` — a B/E
        duration pair on the current (or given) track, and while a
        profiler runs a range of the same name inside it; nested spans
        nest on the timeline exactly like the with-statements do."""
        t = self._tid(tid)
        self._emit({"ph": "B", "ts": self._ts(), "pid": self.pid,
                    "tid": t, "name": name,
                    "args": {k: _arg(v) for k, v in args.items()}})
        try:
            if _profiler_enabled():
                with record_function(name):
                    yield
            else:
                yield
        finally:
            self._emit({"ph": "E", "ts": self._ts(), "pid": self.pid,
                        "tid": t, "name": name})

    def instant(self, name: str, tid: Optional[int] = None,
                **args: Any) -> None:
        """A zero-duration point event (breaker opened, cache hit...)."""
        self._emit({"ph": "i", "ts": self._ts(), "pid": self.pid,
                    "tid": self._tid(tid), "name": name, "s": "t",
                    "args": {k: _arg(v) for k, v in args.items()}})

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, allow_nan=False,
                      default=float)


def _arg(v: Any) -> Any:
    """JSON-safe span-arg coercion (numpy scalars, tuples, ...)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return str(v)


class Telemetry:
    """The facade every instrumented layer takes: one registry + one
    tracer on one shared (injectable) clock. ``Telemetry()`` is wall
    clock; ``Telemetry(clock=fake)`` makes every ``ts``, histogram
    observation timestamp, and ``run_service`` wall measurement
    deterministic."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 pid: int = 0) -> None:
        self.clock = clock if clock is not None else time.perf_counter
        self.registry = MetricsRegistry(clock=self.clock)
        self.tracer = SpanTracer(clock=self.clock, pid=pid)

    # tracer delegates
    def span(self, name: str, tid: Optional[int] = None, **args: Any):
        return self.tracer.span(name, tid=tid, **args)

    def instant(self, name: str, tid: Optional[int] = None,
                **args: Any) -> None:
        self.tracer.instant(name, tid=tid, **args)

    def set_track(self, track: int, label: Optional[str] = None) -> None:
        self.tracer.set_track(track, label)

    # registry delegates
    def inc(self, name: str, n: int = 1) -> None:
        self.registry.inc(name, n)

    def set_gauge(self, name: str, v: float) -> None:
        self.registry.set_gauge(name, v)

    def observe(self, name: str, v: float) -> None:
        self.registry.observe(name, v)

    def record_series(self, name: str, values: Sequence[float]) -> None:
        self.registry.record_series(name, values)

    # export
    def export_trace(self, path: str) -> None:
        self.tracer.export(path)

    def export_metrics(self, out_dir: str) -> Dict[str, str]:
        return self.registry.write(out_dir)


def maybe_span(tel: Optional[Telemetry], name: str, **args: Any):
    """``with maybe_span(tel, "solve", rung=r):`` — a real span when
    telemetry is on, a free ``nullcontext`` when it is off (the
    off-path stays untouched)."""
    if tel is None:
        return _OFF
    return tel.span(name, **args)


#: the off path's context: one shared, reusable ``nullcontext``
_OFF = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# process-global default (the convenience channel for layers with no
# config path: the fleet solver's spans, run_pso_ga's history recorder)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Telemetry] = None
_GLOBAL_LOCK = threading.Lock()


def set_telemetry(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install ``tel`` as the process-global default; returns the
    previous one. Explicit ``telemetry=`` arguments always win over the
    global."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, tel
        return prev


def get_telemetry() -> Optional[Telemetry]:
    with _GLOBAL_LOCK:
        return _GLOBAL


@contextlib.contextmanager
def telemetry_scope(tel: Optional[Telemetry]) -> Iterator[None]:
    """Temporarily install ``tel`` as the global default."""
    prev = set_telemetry(tel)
    try:
        yield
    finally:
        set_telemetry(prev)
