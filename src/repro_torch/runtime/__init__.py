"""Supervision primitives of the planning service, copied from
``repro.runtime`` (plain Python and numpy): fault injection, retries,
the circuit breaker and the EWMA estimators; and the elastic mesh
(``best_mesh_shape``, ``elastic_mesh`` over ``torch.distributed``
ranks)."""
from .elastic import best_mesh_shape, elastic_mesh
from .fault import (CircuitBreaker, FailureInjector, SimulatedFailure,
                    retry_with_backoff, run_with_restarts)
from .straggler import EwmaEstimator, StragglerDetector

__all__ = ["best_mesh_shape", "elastic_mesh", "CircuitBreaker",
           "FailureInjector", "SimulatedFailure", "retry_with_backoff",
           "run_with_restarts", "EwmaEstimator", "StragglerDetector"]
