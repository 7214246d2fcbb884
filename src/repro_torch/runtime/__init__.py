"""Supervision primitives of the planning service, copied from
``repro.runtime`` (plain Python and numpy): fault injection, retries,
the circuit breaker and the EWMA estimators. ``elastic`` (the device
mesh) waits for ROADMAP queue A item 13."""
from .fault import (CircuitBreaker, FailureInjector, SimulatedFailure,
                    retry_with_backoff, run_with_restarts)
from .straggler import EwmaEstimator, StragglerDetector

__all__ = ["CircuitBreaker", "FailureInjector", "SimulatedFailure",
           "retry_with_backoff", "run_with_restarts",
           "EwmaEstimator", "StragglerDetector"]
