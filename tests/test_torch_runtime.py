"""The planning service's supervision primitives in the port
(``repro_torch.runtime``) against the reference (``repro.runtime``,
``tests/test_service.py``'s primitive tests, mirrored): the circuit
breaker, retries with backoff, the EWMA estimator and the straggler
detector, with the same fire sequence, state sequence and estimates as
the reference for the same inputs and seeds; and the replay wrappers'
shared step-table memo under threads."""
import sys
import threading

import numpy as np
import pytest
import torch

import repro.runtime as ref
import repro_torch.runtime as port
from repro_torch.kernels import schedule_sim


# ---------------------------------------------------------------------------
# mirrored primitive tests
# ---------------------------------------------------------------------------

def test_runtime_exports_the_reference_surface_but_elastic():
    """The reference's whole surface: ``best_mesh_shape`` came with the
    training slice, ``elastic_mesh`` with the device mesh
    (``tests/test_torch_mesh.py`` builds it)."""
    assert set(port.__all__) == set(ref.__all__)


def test_circuit_breaker_lifecycle():
    b = port.CircuitBreaker(threshold=2, cooldown=2)
    assert b.state == "closed" and b.allow(1)
    b.record_failure(1)
    assert b.state == "closed"
    b.record_failure(2)
    assert b.state == "open" and b.opened == 1
    assert not b.allow(3) and not b.allow(4)
    assert b.allow(5)
    b.record_failure(5)
    assert b.opened == 2 and not b.allow(7)
    assert b.allow(8)
    b.record_success()
    assert b.state == "closed" and b.allow(9)


@pytest.mark.parametrize("kwargs,match", [({"threshold": 0}, "threshold"),
                                          ({"cooldown": 0}, "cooldown")])
def test_circuit_breaker_rejects_bad_knobs(kwargs, match):
    with pytest.raises(ValueError, match=match):
        port.CircuitBreaker(**kwargs)


def test_retry_with_backoff_recovers_and_sleeps_exponentially():
    sleeps, attempts = [], []

    def flaky(a):
        attempts.append(a)
        if a < 2:
            raise port.SimulatedFailure("boom")
        return "ok"

    assert port.retry_with_backoff(flaky, retries=2, backoff_s=0.1,
                                   sleeper=sleeps.append) == "ok"
    assert attempts == [0, 1, 2]
    np.testing.assert_allclose(sleeps, [0.1, 0.2])


def test_retry_with_backoff_exhausts_then_raises():
    attempts = []

    def dead(a):
        attempts.append(a)
        raise port.SimulatedFailure("still dead")

    with pytest.raises(port.SimulatedFailure):
        port.retry_with_backoff(dead, retries=1, sleeper=lambda s: None)
    assert attempts == [0, 1]


def test_retry_with_backoff_does_not_catch_other_exceptions():
    attempts = []

    def broken(a):
        attempts.append(a)
        raise ValueError("logic bug, not a fault")

    with pytest.raises(ValueError):
        port.retry_with_backoff(broken, retries=5, sleeper=lambda s: None)
    assert attempts == [0]


def test_ewma_estimator():
    e = port.EwmaEstimator(alpha=0.3)
    assert e.value is None
    e.update(1.0)
    assert e.value == pytest.approx(1.0)
    e.update(2.0)
    assert e.value == pytest.approx(1.3)
    for junk in (float("nan"), -5.0, float("inf")):
        e.update(junk)
    assert e.value == pytest.approx(1.3) and e.n == 2
    with pytest.raises(ValueError, match="alpha"):
        port.EwmaEstimator(alpha=0.0)


def test_run_with_restarts_resumes_from_latest():
    inj = port.FailureInjector(fail_at=(3, 7))
    done = []

    def body(start):
        for step in range(start, 10):
            inj.maybe_fail(step)
            done.append(step)
        return 9

    assert port.run_with_restarts(body, lambda: done[-1] if done else None,
                                  max_restarts=2) == 9
    assert done == list(range(10))
    dead = port.FailureInjector(p_fail=1.0)
    with pytest.raises(port.SimulatedFailure):
        port.run_with_restarts(lambda s: dead.maybe_fail(s), lambda: None,
                               max_restarts=3)


# ---------------------------------------------------------------------------
# the port against the reference: the same sequences for the same inputs
# ---------------------------------------------------------------------------

def _fires(lib, steps, **kw):
    inj = lib.FailureInjector(**kw)
    out = []
    for step in steps:
        try:
            inj.maybe_fail(step)
            out.append(None)
        except lib.SimulatedFailure as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("kw", [
    dict(p_fail=0.3, seed=5),
    dict(p_fail=0.1, seed=123, fail_at=(4, 9), max_failures=6),
    dict(fail_at=(0, 2, 2, 5)),
])
def test_failure_injector_fires_as_the_reference(kw):
    steps = [0, 1, 2, 2, 3, 4, 5, 5] + list(range(6, 200))
    want = _fires(ref, steps, **kw)
    assert _fires(port, steps, **kw) == want
    assert any(w is not None for w in want)


def _breaker_states(lib, outcomes):
    b = lib.CircuitBreaker(threshold=2, cooldown=3)
    out = []
    for k, fail in enumerate(outcomes, start=1):
        allowed = b.allow(k)
        if allowed:
            if fail:
                b.record_failure(k)
            else:
                b.record_success()
        out.append((allowed, b.state, b.opened))
    return out


def test_breaker_state_sequence_equals_reference():
    outcomes = np.random.default_rng(3).random(300) < 0.45
    assert _breaker_states(port, outcomes) == _breaker_states(ref, outcomes)


def test_ewma_and_straggler_sequences_equal_reference():
    v = np.random.default_rng(9).gamma(2.0, 0.05, 400)
    v[[50, 120, 121, 300]] = [3.0, 4.5, 9.0, float("nan")]
    a, b = ref.EwmaEstimator(alpha=0.2), port.EwmaEstimator(alpha=0.2)
    sa, sb = ref.StragglerDetector(warmup=3), port.StragglerDetector(
        warmup=3)
    for x in v:
        a.update(x)
        b.update(x)
        assert (a.value, a.n) == (b.value, b.n)
        if np.isfinite(x):
            assert sa.update(float(x)) == sb.update(float(x))
            assert (sa.mean, sa.std, sa.flagged) == \
                (sb.mean, sb.std, sb.flagged)
    assert sb.flagged >= 3


# ---------------------------------------------------------------------------
# the replay wrappers' step-table memo under threads
# ---------------------------------------------------------------------------

def test_memo_tables_under_four_threads():
    """Four threads hammer ``_memo_tables`` over more keys than it keeps:
    every call returns the tables of its own sources, the memo never
    holds more than ``_TABLES_KEPT`` entries, and nothing raises (an
    unlocked ``move_to_end`` after another thread's eviction would)."""
    srcs = [(torch.full((3,), i, dtype=torch.int32),
             torch.full((2, 2), -i, dtype=torch.int32))
            for i in range(3 * schedule_sim._TABLES_KEPT)]
    errors, wrong = [], []
    switch = sys.getswitchinterval()

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(5000):
                i = int(rng.integers(len(srcs)))
                a, b = srcs[i]
                got = schedule_sim._memo_tables(
                    "hammer", (a, b), lambda a=a, b=b: (a.sum(), b.sum()))
                if int(got[0]) != 3 * i or int(got[1]) != -4 * i:
                    wrong.append((i, got))
        except Exception as e:            # reported by the assert below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and wrong == []
    assert len(schedule_sim._TABLES) <= schedule_sim._TABLES_KEPT
