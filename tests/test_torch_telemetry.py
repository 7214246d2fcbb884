"""Telemetry in the port (``repro_torch.core.telemetry``) against the
reference (``tests/test_telemetry.py``, mirrored): the metric primitives,
the registry's thread-safety and exporters, the span tracer's Chrome
trace-event schema, byte-equal JSONL, Prometheus and Chrome-trace exports
for the same operations under a fake clock, and the service integration —
telemetry off is bit-identical to on, the registry agrees with
``ServiceReport``, and a chaos run's trace passes ``scripts/check_trace.py``
with the reference's required span names."""
import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.telemetry as ref_tel
import repro_torch.core as port
from repro_torch.core.dag import LayerDAG
from repro_torch.core.telemetry import (Counter, Gauge, Histogram,
                                        MetricsRegistry, Series, SpanTracer)

torch.set_num_threads(1)

FAST = port.PSOGAConfig(pop_size=19, max_iters=40, stall_iters=15)
RCFG = port.ReplanConfig(pso=FAST)
#: the reference's CI span list (tests/test_telemetry.py); its
#: ``runner_cache_*`` instants count JAX's compiled runners and have no
#: counterpart in the port
REQUIRED_SPANS = ["round", "solve", "cache_lookup", "ladder",
                  "replan_round", "fleet_solve", "cold_solve"]


def _tiny_dag(env, pin):
    return LayerDAG(
        compute=np.array([1.1, 1.92, 2.35, 2.12]) * env.power[0],
        edges=np.array([[0, 1], [0, 2], [1, 3], [2, 3]]),
        edge_mb=np.array([1.0, 1.0, 0.5, 0.5]),
        app_id=np.zeros(4, np.int32), deadline=np.array([3.7]),
        pinned=np.array([pin, -1, -1, -1], np.int32))


@pytest.fixture(scope="module")
def tiny_fleet():
    env = port.sample_environment()
    return env, [_tiny_dag(env, 0), _tiny_dag(env, 1)]


def _check_trace_module():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "scripts", "check_trace.py")
    spec = importlib.util.spec_from_file_location("check_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeClock:
    """Deterministic clock: advances by ``step`` on every call."""

    def __init__(self, step: float = 0.001):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# primitives (mirrored)
# ---------------------------------------------------------------------------

def test_counter_is_monotonic():
    c = Counter("x")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    assert c.value == 5


def test_gauge_last_value_wins():
    g = Gauge("x")
    g.set(3.5)
    g.set(-1.0)
    assert g.value == -1.0


def test_histogram_exact_moments_and_quantiles():
    h = Histogram("lat")
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100 and s["sum"] == pytest.approx(5050.0)
    assert s["min"] == 1.0 and s["max"] == 100.0
    assert s["p50"] == pytest.approx(50.5)
    assert s["p95"] == pytest.approx(np.percentile(np.arange(1, 101), 95))
    assert h.quantile(0) == 1.0 and h.quantile(100) == 100.0


def test_histogram_reservoir_is_bounded_and_matches_reference():
    h1, h2 = Histogram("b", reservoir=64), Histogram("b", reservoir=64)
    href = ref_tel.Histogram("b", reservoir=64)
    for v in range(10_000):
        for h in (h1, h2, href):
            h.observe(float(v))
    assert len(h1._res) == 64 and h1.count == 10_000
    assert h1.summary() == h2.summary() == href.summary()
    assert h1._res == href._res
    with pytest.raises(ValueError, match="reservoir"):
        Histogram("bad", reservoir=0)


def test_series_bounds_and_extend():
    s = Series("gbest", max_points=8)
    s.extend(100.0, np.arange(12.0))
    assert s.summary() == {"n": 8, "dropped": 4, "last": 11.0}
    ts = [t for t, _ in s.points()]
    assert ts == sorted(ts)


def test_registry_get_or_create_and_kind_conflict():
    r = MetricsRegistry()
    assert r.counter("a") is r.counter("a")
    with pytest.raises(TypeError, match="Counter"):
        r.gauge("a")


def test_registry_thread_safety():
    r = MetricsRegistry()
    n_threads, n_ops = 8, 1000

    def work():
        for i in range(n_ops):
            r.inc("c")
            r.observe("h", float(i))
            r.set_gauge("g", float(i))

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert r.counter("c").value == n_threads * n_ops
    assert r.histogram("h").count == n_threads * n_ops


def test_registry_exports_parse(tmp_path):
    r = MetricsRegistry()
    r.inc("svc.rounds", 3)
    r.set_gauge("svc.depth", 2.0)
    r.observe("svc.wall", 0.25)
    r.record_series("svc.gbest", [3.0, 2.0, 1.0])
    for line in r.to_jsonl().splitlines():
        assert {"type", "name"} <= set(json.loads(line))
    prom = r.to_prometheus()
    assert "svc_rounds_total 3" in prom
    assert 'svc_wall{quantile="0.5"}' in prom
    assert "svc_gbest_last 1.0" in prom
    snap = r.snapshot()
    assert snap["counters"]["svc.rounds"] == 3
    assert snap["series"]["svc.gbest"]["n"] == 3
    paths = r.write(str(tmp_path / "m"))
    assert json.loads(open(paths["jsonl"]).readline())["name"] == "svc.rounds"
    assert "# TYPE" in open(paths["prom"]).read()


def test_tracer_emits_paired_nested_spans():
    tr = SpanTracer(clock=FakeClock())
    with tr.span("outer", round=1):
        with tr.span("inner"):
            tr.instant("hit", key="k")
    evs = tr.events()
    assert [e["ph"] for e in evs] == ["B", "B", "i", "E", "E"]
    assert [e["name"] for e in evs] == ["outer", "inner", "hit", "inner",
                                       "outer"]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts) and ts[0] >= 0.0
    assert evs[0]["args"] == {"round": 1} and evs[2]["s"] == "t"


def test_tracer_span_closes_on_exception():
    tr = SpanTracer(clock=FakeClock())
    with pytest.raises(RuntimeError):
        with tr.span("risky"):
            raise RuntimeError("boom")
    assert [e["ph"] for e in tr.events()] == ["B", "E"]


def test_tracer_tracks_are_thread_local():
    tr = SpanTracer(clock=time.perf_counter)
    tr.set_track(7, label="service-7")

    def other():
        tr.set_track(9)
        with tr.span("theirs"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    with tr.span("mine"):
        pass
    by_name = {e["name"]: e for e in tr.events() if e["ph"] == "B"}
    assert by_name["theirs"]["tid"] == 9 and by_name["mine"]["tid"] == 7
    meta = [e for e in tr.events() if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == "service-7" and meta[0]["tid"] == 7


def test_maybe_span_and_global_scope():
    with port.maybe_span(None, "anything", round=3):
        pass
    tel = port.Telemetry(clock=FakeClock())
    with port.maybe_span(tel, "real"):
        pass
    assert len(tel.tracer.events()) == 2
    assert port.get_telemetry() is None
    with port.telemetry_scope(tel):
        assert port.get_telemetry() is tel
        with port.telemetry_scope(None):
            assert port.get_telemetry() is None
        assert port.get_telemetry() is tel
    assert port.get_telemetry() is None


def test_maybe_span_off_is_one_shared_nullcontext():
    """Telemetry off: every span is the same no-op context, no tracer, no
    profiler range."""
    a, b = port.maybe_span(None, "serve.decode_step", step=1), \
        port.maybe_span(None, "ssd.intra")
    assert a is b
    with a:
        with b:
            pass


def test_span_is_a_profiler_range_of_its_name():
    """Each span also opens a ``record_function`` range of its name, so the
    profiler puts the operations run inside it under it; the B/E events are
    the tracer's as before."""
    tel = port.Telemetry(clock=FakeClock())
    x = torch.ones(8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.span("outer", n=1):
            with tel.span("inner"):
                y = x + 1
            y = y * 2
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    ops = [(e.name(), e.start_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in ("aten::add", "aten::mul")]
    assert set(ranges) == {"outer", "inner"}
    (_, t_add), = [o for o in ops if o[0] == "aten::add"]
    (_, t_mul), = [o for o in ops if o[0] == "aten::mul"]
    assert ranges["inner"][0] <= t_add <= ranges["inner"][1]
    assert not ranges["inner"][0] <= t_mul <= ranges["inner"][1]
    assert ranges["outer"][0] <= t_mul <= ranges["outer"][1]
    assert [(e["ph"], e["name"]) for e in tel.tracer.events()] == [
        ("B", "outer"), ("B", "inner"), ("E", "inner"), ("E", "outer")]
    assert float(y.sum()) == 32.0


# ---------------------------------------------------------------------------
# byte-equal exports against the reference
# ---------------------------------------------------------------------------

def _drive(lib, clock):
    """The same operations on a ``Telemetry`` of either package."""
    tel = lib.Telemetry(clock=clock, pid=3)
    tel.set_track(2, label="service-2")
    rng = np.random.default_rng(4)
    with tel.span("round", round=1, label="wifi-fade[0.41]"):
        with tel.span("solve", rung="warm", n=np.int64(3)):
            for v in rng.gamma(2.0, 0.01, 900):
                tel.observe("service.round_wall_s", float(v))
            tel.instant("cache_hit", round=1, scale=np.float32(0.5))
        tel.inc("service.rung.warm", 3)
        tel.set_gauge("ingest.depth", 2.0)
        tel.record_series("solver.gbest", rng.random(40))
    tel.inc("plancache.hits")
    tel.registry.series("short", max_points=5).extend(1.0, np.arange(9.0))
    return tel


def test_exports_are_byte_equal_to_reference(tmp_path):
    a = _drive(ref_tel, FakeClock(0.0007))
    b = _drive(port, FakeClock(0.0007))
    assert b.registry.to_jsonl() == a.registry.to_jsonl()
    assert b.registry.to_prometheus() == a.registry.to_prometheus()
    assert b.registry.snapshot() == a.registry.snapshot()
    a.export_trace(str(tmp_path / "a.json"))
    b.export_trace(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    pa, pb = a.export_metrics(str(tmp_path / "ma")), \
        b.export_metrics(str(tmp_path / "mb"))
    for k in ("jsonl", "prom"):
        assert open(pa[k], "rb").read() == open(pb[k], "rb").read()


# ---------------------------------------------------------------------------
# the solver and the service, with telemetry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_pair(tiny_fleet):
    """One 10-round chaos service run with telemetry, one without."""
    env, dags = tiny_fleet
    trace = port.sample_trace("wifi-fade", env, rounds=10, seed=3)
    cfg = port.ServiceConfig(
        replan=RCFG, plan_cache=port.PlanCacheConfig(),
        straggler_warmup=100,
        chaos=port.ChaosConfig(crash_rounds=(2,), nan_env_rounds=(4,),
                               mid_round_down={6: 1}))
    tel = port.Telemetry()
    with_tel = port.run_service(dags, trace, cfg, seed=7, telemetry=tel,
                                device="cpu")
    without = port.run_service(dags, trace, cfg, seed=7, device="cpu")
    return tel, with_tel, without


def test_service_telemetry_off_parity(chaos_pair):
    _, a, b = chaos_pair
    assert a.counters == b.counters
    assert a.fallback_counts == b.fallback_counts
    assert a.cache_stats == b.cache_stats
    for ra, rb in zip(a.rounds, b.rounds):
        assert (ra.rung, ra.label, ra.breaker_state, ra.solver_failed,
                ra.stale_env, ra.cache_hit, ra.budget_iters) == \
            (rb.rung, rb.label, rb.breaker_state, rb.solver_failed,
             rb.stale_env, rb.cache_hit, rb.budget_iters)
        if ra.replan is not None:
            np.testing.assert_array_equal(ra.replan.candidate_key,
                                          rb.replan.candidate_key)
    for pa, pb in zip(a.plans, b.plans):
        assert np.array_equal(pa, pb)


def test_service_counters_agree_with_registry(chaos_pair):
    tel, rep, _ = chaos_pair
    snap = tel.registry.snapshot()
    for name, v in rep.counters.items():
        assert snap["counters"].get(f"service.{name}", 0) == v, name
    for rung, v in rep.fallback_counts.items():
        assert snap["counters"].get(f"service.rung.{rung}", 0) == v, rung
    for name, v in rep.cache_stats.items():
        assert snap["counters"].get(f"plancache.{name}", 0) == v, name
    solved = [r for r in rep.rounds if r.replan is not None]
    assert snap["counters"]["online.rounds"] == len(solved)
    assert snap["counters"]["online.replanned"] == \
        sum(int(r.replan.replanned.sum()) for r in solved)
    assert snap["histograms"]["service.round_wall_s"]["count"] == \
        len(rep.rounds)
    assert not any(k.startswith("runner_cache") for k in
                   list(snap["counters"]) + list(snap["gauges"]))


def test_service_trace_passes_ci_validator(chaos_pair, tmp_path):
    tel, _, _ = chaos_pair
    path = str(tmp_path / "chaos_trace.json")
    tel.export_trace(path)
    tel.export_metrics(str(tmp_path / "m"))
    ct = _check_trace_module()
    assert ct.check_trace(path, require=REQUIRED_SPANS) > 0
    ct.check_metrics(str(tmp_path / "m"))
    names = {e["name"] for e in tel.tracer.events()}
    assert {"incumbent_keys", "warm_solve", "stale_env",
            "mid_round_down"} <= names


def test_service_ingest_counters_always_present(chaos_pair):
    _, rep, without = chaos_pair
    for r in (rep, without):
        for k in ("ingest_enqueued", "ingest_dropped", "ingest_drained",
                  "ingest_leftover"):
            assert r.counters[k] == 0


def test_service_walls_use_injectable_clock(tiny_fleet):
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=3)
    cfg = port.ServiceConfig(replan=RCFG)

    def run():
        tel = port.Telemetry(clock=FakeClock(step=0.001))
        rep = port.run_service(dags, trace, cfg, seed=7, telemetry=tel,
                               device="cpu")
        return ([r.wall_s for r in rep.rounds],
                [r.replan.wall_s for r in rep.rounds])

    (walls_a, inner_a), (walls_b, inner_b) = run(), run()
    assert walls_a == walls_b and inner_a == inner_b
    for w in walls_a + inner_a:
        assert w > 0.0
        assert round(w / 0.001) == pytest.approx(w / 0.001)


def test_run_services_shared_telemetry_tracks(tiny_fleet):
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=2)
    cfg = port.ServiceConfig(replan=RCFG)
    tel = port.Telemetry()
    reports = port.run_services([dags, dags], trace, cfg, seeds=5,
                                telemetry=tel, device="cpu")
    solo = port.run_service(dags, trace, cfg, seed=5, device="cpu")
    for rep in reports:
        assert rep.counters == solo.counters
        for x, x_solo in zip(rep.plans, solo.plans):
            assert np.array_equal(x, x_solo)
    evs = tel.tracer.events()
    labels = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert labels == {0: "service-0", 1: "service-1"}
    assert {e["tid"] for e in evs if e["ph"] == "B"} == {0, 1}
    for tid in (0, 1):
        stack = []
        for e in evs:
            if e["tid"] != tid:
                continue
            if e["ph"] == "B":
                stack.append(e["name"])
            elif e["ph"] == "E":
                assert stack and stack.pop() == e["name"]
        assert stack == []
    snap = tel.registry.snapshot()
    assert snap["histograms"]["service.round_wall_s"]["count"] == \
        2 * len(solo.rounds)


def test_solver_history_becomes_series(tiny_fleet):
    env, dags = tiny_fleet
    cfg = port.PSOGAConfig(pop_size=8, max_iters=12, stall_iters=12)
    tel = port.Telemetry()
    res = port.run_pso_ga(dags[0], env, cfg, seed=1, record_history=True,
                          device="cpu", telemetry=tel)
    pts = tel.registry.series("solver.gbest").points()
    assert [v for _, v in pts] == [float(v) for v in res.history]
    assert tel.registry.counter("solver.history_runs").value == 1
    assert tel.tracer.events() == []      # a single solve opens no span
    plain = port.run_pso_ga(dags[0], env, cfg, seed=1, record_history=True,
                            device="cpu")
    np.testing.assert_array_equal(plain.best_x, res.best_x)
    np.testing.assert_array_equal(plain.history, res.history)


def test_global_channel_reaches_the_fleet_solver(tiny_fleet):
    """The process-global channel reaches ``run_pso_ga_batch``'s
    ``fleet_solve`` spans, one per bucket, each closing after the
    bucket's results reached the host; the solve is unchanged."""
    env, dags = tiny_fleet
    trace = port.zero_drift_trace(env, rounds=2)
    tel = port.Telemetry()
    with port.telemetry_scope(tel):
        rep = port.run_service(dags, trace, port.ServiceConfig(replan=RCFG),
                               seed=3, device="cpu")
    assert port.set_telemetry(None) is None
    solves = [e for e in tel.tracer.events() if e["name"] == "fleet_solve"]
    assert len(solves) == 4                 # cold + one warm, B and E each
    assert solves[0]["args"] == {"bucket": "8x8", "n": 2,
                                 "traffic": False, "sharded": False}
    assert "service.round_wall_s" in tel.registry.snapshot()["histograms"]
    base = port.run_service(dags, trace, port.ServiceConfig(replan=RCFG),
                            seed=3, device="cpu")
    for x, y in zip(rep.plans, base.plans):
        assert np.array_equal(x, y)
