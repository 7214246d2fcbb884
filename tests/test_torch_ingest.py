"""Async arrival ingestion in the port (``repro_torch.core.traffic``'s
``IngestConfig`` and ``ArrivalQueue``, and ``run_service``'s ingest modes)
against the reference (``tests/test_ingest.py``, mirrored): queue
semantics and backpressure counters equal to the reference's for the same
operations, the deterministic single-thread mode bit-identical to the
synchronous draws, and the threaded producers' conservation law."""
import threading

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port

torch.set_num_threads(1)

FAST = port.PSOGAConfig(pop_size=20, max_iters=50, stall_iters=18)
TCFG = port.TrafficConfig(rate=0.4, max_requests=4, mc_solver=2, mc_eval=4)
RCFG_T = port.ReplanConfig(pso=FAST, traffic=TCFG)


@pytest.fixture(scope="module")
def fleet():
    env = port.paper_environment()
    dags = []
    for i, net in enumerate(("alexnet", "googlenet")):
        dag = port.zoo.build(net, pin_server=i)
        h, _ = port.heft_makespan(dag, env)
        dags.append(dag.with_deadline(np.array([1.5 * h])))
    return env, dags, port.sample_trace("load-surge", env, rounds=4, seed=5)


@pytest.fixture(scope="module")
def legacy(fleet):
    """The synchronous estimate_rates path (no queue)."""
    _, dags, trace = fleet
    return port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG_T, estimate_rates=True, window_rounds=2), seed=7,
        device="cpu")


# ---------------------------------------------------------------------------
# ArrivalQueue / IngestConfig
# ---------------------------------------------------------------------------

def test_arrival_queue_fifo_and_counters():
    q = port.ArrivalQueue(capacity=4)
    for i in range(3):
        assert q.put(i)
    assert q.depth() == 3
    assert q.drain() == [0, 1, 2]
    assert q.depth() == 0 and q.drain() == []
    assert q.counters() == {"enqueued": 3, "dropped": 0, "drained": 3,
                            "max_depth": 3, "depth": 0}


def test_arrival_queue_drops_when_full():
    q = port.ArrivalQueue(capacity=2)
    assert q.put("a") and q.put("b")
    assert not q.put("c")
    c = q.counters()
    assert c["enqueued"] == 2 and c["dropped"] == 1
    assert q.drain() == ["a", "b"]


def test_arrival_queue_rejects_bad_capacity():
    with pytest.raises(ValueError, match="capacity"):
        port.ArrivalQueue(capacity=0)


@pytest.mark.parametrize("kwargs,match", [({"threads": -1}, "threads"),
                                          ({"capacity": 0}, "capacity")])
def test_ingest_config_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        port.IngestConfig(**kwargs)


def test_queue_counts_equal_reference():
    """The same puts and drains, with a telemetry channel each: results,
    counters and the mirrored registry export are equal."""
    def script(lib):
        tel = lib.Telemetry(clock=lambda: 0.0)
        q = lib.ArrivalQueue(capacity=3, telemetry=tel)
        rng = np.random.default_rng(1)
        out = []
        for step in range(60):
            if rng.random() < 0.3:
                out.append(("drain", q.drain()))
            else:
                out.append(("put", q.put(step)))
        return out, q.counters(), tel.registry.to_jsonl()

    assert script(port) == script(ref)


def test_arrival_queue_conserves_under_threads():
    q = port.ArrivalQueue(capacity=50)
    drained = []
    done = threading.Event()

    def produce():
        for i in range(500):
            q.put(i)

    def consume():
        while not done.is_set():
            drained.extend(q.drain())

    prods = [threading.Thread(target=produce) for _ in range(4)]
    cons = threading.Thread(target=consume)
    cons.start()
    for t in prods:
        t.start()
    for t in prods:
        t.join(timeout=60)
    done.set()
    cons.join(timeout=60)
    drained.extend(q.drain())
    assert not any(t.is_alive() for t in prods + [cons])
    c = q.counters()
    assert c["enqueued"] + c["dropped"] == 2000
    assert c["drained"] == len(drained) == c["enqueued"]


# ---------------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------------

def test_service_config_ingest_requires_estimation():
    with pytest.raises(ValueError, match="estimate_rates"):
        port.ServiceConfig(ingest=port.IngestConfig())


def test_run_service_ingest_requires_traffic(fleet):
    _, dags, trace = fleet
    cfg = port.ServiceConfig(replan=port.ReplanConfig(pso=FAST),
                             estimate_rates=True, ingest=port.IngestConfig())
    with pytest.raises(ValueError, match="traffic"):
        port.run_service(dags, trace, cfg, seed=1, device="cpu")


def test_sync_ingest_bit_identical_to_legacy(fleet, legacy):
    _, dags, trace = fleet
    queued = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG_T, estimate_rates=True, window_rounds=2,
        ingest=port.IngestConfig(threads=0)), seed=7, device="cpu")
    for rl, rq in zip(legacy.rounds, queued.rounds):
        assert rq.est_rates == rl.est_rates and rq.rung == rl.rung
        np.testing.assert_array_equal(rq.replan.candidate_key,
                                      rl.replan.candidate_key)
    for xl, xq in zip(legacy.plans, queued.plans):
        assert np.array_equal(xl, xq)
    c = queued.counters
    assert c["ingest_enqueued"] == (trace.num_rounds - 1) * len(dags)
    assert c["ingest_dropped"] == 0 and c["ingest_leftover"] == 0
    assert c["ingest_drained"] == c["ingest_enqueued"]


def test_estimates_equal_reference_window(fleet, legacy):
    """The port's per-DAG rate estimates are the reference's sliding
    window over the reference's own observation draws."""
    from repro.core.service import _RateWindow
    _, dags, trace = fleet
    tc = ref.TrafficConfig(rate=0.4, max_requests=4, mc_solver=2, mc_eval=4)
    wins = [_RateWindow(2, tc.horizon, d.num_apps) for d in dags]
    for r in legacy.rounds:
        for i, d in enumerate(dags):
            wins[i].ingest(tc.solver_arrivals(
                d.num_apps, seed=7 + 7919 * r.round + 31 * i,
                rate_scale=trace.events[r.round].load_scale)[0])
        assert r.est_rates == tuple(w.rate() for w in wins)


def test_sync_ingest_backpressure_drops_deterministically(fleet):
    _, dags, trace = fleet
    rep = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG_T, estimate_rates=True, window_rounds=2,
        ingest=port.IngestConfig(threads=0, capacity=1)), seed=7,
        device="cpu")
    c = rep.counters
    assert c["ingest_dropped"] == (trace.num_rounds - 1) * (len(dags) - 1)
    assert c["ingest_enqueued"] == trace.num_rounds - 1
    assert rep.availability() == 1.0


def test_threaded_ingest_serves_every_round(fleet):
    _, dags, trace = fleet
    rep = port.run_service(dags, trace, port.ServiceConfig(
        replan=RCFG_T, estimate_rates=True, window_rounds=2,
        ingest=port.IngestConfig(threads=2, capacity=64)), seed=7,
        device="cpu")
    assert rep.availability() == 1.0
    c = rep.counters
    assert c["ingest_enqueued"] == c["ingest_drained"] + c["ingest_leftover"]
    assert c["ingest_dropped"] + c["ingest_enqueued"] \
        == (trace.num_rounds - 1) * len(dags)
    assert all(len(r.est_rates) == len(dags) for r in rep.rounds)
    for dag, x in zip(dags, rep.plans):
        assert port.plan_is_valid(port.SimProblem.build(
            dag, trace.env_at(trace.num_rounds - 1)), x)
