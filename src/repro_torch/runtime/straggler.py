"""Straggler detection via EWMA step-time outliers: a copy of
``repro.runtime.straggler`` (plain Python, no numpy needed).

In synchronous data parallelism one slow host gates every step (the
collective waits). Detection is cheap: keep an EWMA + EWVar of the step
time; a step slower than ``mean + k·std`` (and ``> ratio × mean``) flags
a straggler. Mitigation at scale is out-of-band (re-schedule the host,
shrink the mesh via ``runtime.elastic``: the trainer on a mesh restores
its whole-tensor checkpoints onto any mesh); here the detector reports
and the trainer logs + counts, on a mesh every rank the same flag (rank
0's step time), and the restart/elastic path is exercised by tests.

Welford-style EWMA keeps no history; O(1) per step.

``EwmaEstimator`` is the bare smoother without outlier logic — the
planning service's solver watchdog (DESIGN.md §11) feeds it observed
per-iteration solve times and divides remaining SLO slack by its value
to derive the iteration budget of the next solve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["StragglerDetector", "EwmaEstimator"]


@dataclasses.dataclass
class EwmaEstimator:
    """O(1) exponentially-weighted mean of a nonnegative stream.

    ``value`` is None until the first update (callers treat "no estimate
    yet" as "don't budget"). Non-finite or negative samples are ignored
    rather than poisoning the estimate — the watchdog may be fed wall
    times measured around a crashed solve.
    """
    alpha: float = 0.3

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        self._mean: Optional[float] = None
        self._n = 0

    @property
    def value(self) -> Optional[float]:
        return self._mean

    @property
    def n(self) -> int:
        return self._n

    def update(self, v: float) -> None:
        v = float(v)
        if not (v >= 0.0) or v != v or v == float("inf"):
            return
        self._n += 1
        if self._mean is None:
            self._mean = v
        else:
            self._mean += self.alpha * (v - self._mean)


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA smoothing
    k_std: float = 4.0          # sigma threshold
    min_ratio: float = 1.5      # AND step > ratio x mean
    warmup: int = 5             # first steps (compile!) never flag

    def __post_init__(self):
        self._mean: Optional[float] = None
        self._var: float = 0.0
        self._n = 0
        self.flagged = 0

    @property
    def mean(self) -> float:
        return self._mean or 0.0

    @property
    def std(self) -> float:
        return self._var ** 0.5

    def update(self, dt: float) -> bool:
        """Feed one step time (seconds); returns True if it's a straggler
        step. Flagged steps do NOT update the running stats (a straggler
        should not inflate its own threshold)."""
        self._n += 1
        if self._mean is None:
            self._mean = dt
            return False
        is_outlier = (self._n > self.warmup
                      and dt > self._mean + self.k_std * self.std
                      and dt > self.min_ratio * self._mean)
        if is_outlier:
            self.flagged += 1
            return True
        delta = dt - self._mean
        self._mean += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var
                                        + self.alpha * delta * delta)
        return False
