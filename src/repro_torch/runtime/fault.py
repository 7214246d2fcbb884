"""Fault injection + checkpoint-restart supervision + circuit breaking: a
copy of ``repro.runtime.fault`` (numpy only), so ``FailureInjector`` fires
at the same steps as the reference's for the same seed.

At thousand-node scale the MTBF of the *job* is hours even when each node
is months; the only viable posture is: checkpoint often, detect fast,
restart from latest. ``run_with_restarts`` is the single-controller
supervisor loop: it runs ``body(start_step)`` and, on a (simulated or
real) failure, restores from the latest checkpoint and re-enters.

``FailureInjector`` raises ``SimulatedFailure`` with probability
``p_fail`` per step (deterministic in seed — tests inject at exact steps
with ``fail_at``). Real deployments plug hardware signals in instead;
everything downstream is identical.

The always-on planning service (DESIGN.md §11) adds two more supervision
primitives on the same philosophy — detect fast, degrade instead of
dying:

  * ``retry_with_backoff`` — bounded retries of a flaky callable with
    exponential backoff (the sleeper is injectable so tests never
    actually sleep).
  * ``CircuitBreaker`` — after ``threshold`` consecutive failures the
    breaker *opens*: callers skip the failing dependency (the service
    pins its last-good plan) until ``cooldown`` rounds pass, then one
    half-open probe decides between closing and re-opening.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, TypeVar

import numpy as np

__all__ = ["SimulatedFailure", "FailureInjector", "run_with_restarts",
           "retry_with_backoff", "CircuitBreaker"]

_T = TypeVar("_T")


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    p_fail: float = 0.0
    seed: int = 0
    fail_at: Sequence[int] = ()          # deterministic injection points
    max_failures: int = 1_000_000

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._failures = 0
        self._fired = set()

    def maybe_fail(self, step: int) -> None:
        if self._failures >= self.max_failures:
            return
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            self._failures += 1
            raise SimulatedFailure(f"injected failure at step {step}")
        if self.p_fail and self._rng.random() < self.p_fail:
            self._failures += 1
            raise SimulatedFailure(f"random failure at step {step}")


def run_with_restarts(body: Callable[[int], int],
                      latest_step: Callable[[], Optional[int]],
                      max_restarts: int = 10) -> int:
    """Supervise ``body(start_step) -> final_step``.

    ``latest_step()`` queries the checkpoint manager. On failure the body
    re-enters from ``latest + 1`` (or 0). Returns the final step. Raises
    after ``max_restarts`` consecutive failures (crash-looping guard).
    """
    restarts = 0
    while True:
        start = latest_step()
        start = 0 if start is None else start + 1
        try:
            return body(start)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


def retry_with_backoff(fn: Callable[[int], _T], retries: int = 2,
                       backoff_s: float = 0.0,
                       sleeper: Optional[Callable[[float], None]] = None,
                       exceptions: tuple = (SimulatedFailure,)) -> _T:
    """Call ``fn(attempt)`` up to ``1 + retries`` times.

    Between attempts sleeps ``backoff_s · 2^attempt`` seconds via
    ``sleeper`` (``time.sleep`` by default; tests inject a recorder so
    nothing actually blocks — and a ``backoff_s`` of 0 never sleeps at
    all). Only ``exceptions`` are retried; anything else propagates
    immediately. Re-raises the last failure when every attempt fails.
    """
    import time as _time
    sleep = _time.sleep if sleeper is None else sleeper
    err: Optional[BaseException] = None
    for attempt in range(1 + max(0, retries)):
        if attempt and backoff_s > 0.0:
            sleep(backoff_s * (2.0 ** (attempt - 1)))
        try:
            return fn(attempt)
        except exceptions as e:          # noqa: PERF203 — bounded loop
            err = e
    assert err is not None
    raise err


@dataclasses.dataclass
class CircuitBreaker:
    """Consecutive-failure circuit breaker (DESIGN.md §11).

    closed → (``threshold`` consecutive failures) → open for ``cooldown``
    rounds → half-open: ``allow`` admits one probe; its outcome closes or
    re-opens the breaker. Round numbers are caller-supplied monotonic
    ints (the service's replan round), so the breaker is deterministic —
    no wall clock involved.
    """
    threshold: int = 2
    cooldown: int = 2

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {self.threshold}")
        if self.cooldown < 1:
            raise ValueError(f"cooldown must be >= 1, got {self.cooldown}")
        self._consecutive = 0
        self._open_until: Optional[int] = None
        self.opened = 0                  # times the breaker tripped open

    @property
    def state(self) -> str:
        if self._open_until is None:
            return "closed"
        return "open"

    def allow(self, round_no: int) -> bool:
        """May the protected call run this round? Open rounds before the
        cooldown expires are skipped; the first round at/after expiry is
        the half-open probe."""
        return self._open_until is None or round_no >= self._open_until

    def record_failure(self, round_no: int) -> None:
        self._consecutive += 1
        if self._consecutive >= self.threshold or self._open_until is not None:
            # trip (or re-trip after a failed half-open probe)
            self._open_until = round_no + 1 + self.cooldown
            self.opened += 1
            self._consecutive = 0

    def record_success(self) -> None:
        self._consecutive = 0
        self._open_until = None
