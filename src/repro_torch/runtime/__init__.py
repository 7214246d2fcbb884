"""Supervision primitives of the planning service, copied from
``repro.runtime`` (plain Python and numpy): fault injection, retries,
the circuit breaker and the EWMA estimators; and the elastic mesh's
shape policy, ``best_mesh_shape`` (building the mesh, ``elastic_mesh``,
waits for ROADMAP queue A item 13)."""
from .elastic import best_mesh_shape
from .fault import (CircuitBreaker, FailureInjector, SimulatedFailure,
                    retry_with_backoff, run_with_restarts)
from .straggler import EwmaEstimator, StragglerDetector

__all__ = ["best_mesh_shape", "CircuitBreaker", "FailureInjector",
           "SimulatedFailure", "retry_with_backoff", "run_with_restarts",
           "EwmaEstimator", "StragglerDetector"]
