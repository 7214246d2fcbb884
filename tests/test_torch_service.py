"""The always-on planning service in the port (``repro_torch.core.service``)
against the reference (``tests/test_service.py`` and the seeded sweep of
``tests/test_service_properties.py``, mirrored): the parity invariant
(protections off ⇒ ``run_service`` is the port's ``replan_fleet`` bit for
bit, with and without traffic), the chaos harness, the watchdog, ladder,
triage and rate-estimation paths, ``run_services`` against each service
alone, and the service logic of both packages around one shared stub
solver: the same rungs, breaker states, budgets, walls, counters, cache
stats, plans and telemetry exports."""
import dataclasses
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.service as ref_service
import repro_torch.core as port
import repro_torch.core.service as port_service
from repro_torch.core.dag import LayerDAG
from repro_torch.core.online import _identity_event, _round_arrivals
from repro_torch.core.service import _RateWindow, _down_env, _select_rung

torch.set_num_threads(1)

FAST = port.PSOGAConfig(pop_size=20, max_iters=50, stall_iters=18)
BURST = port.PSOGAConfig(pop_size=12, max_iters=10, stall_iters=6)
RCFG = port.ReplanConfig(pso=FAST)
TCFG = port.TrafficConfig(rate=0.4, max_requests=4, mc_solver=2, mc_eval=4)
RCFG_T = port.ReplanConfig(pso=FAST, traffic=TCFG)


def _fleet(lib, deadlines=(1.5, 1.5)):
    env = lib.paper_environment()
    dags = []
    for i, (net, r) in enumerate(zip(("alexnet", "googlenet"), deadlines)):
        dag = lib.zoo.build(net, pin_server=i)
        h, _ = lib.heft_makespan(dag, env)
        dags.append(dag.with_deadline(np.array([r * h])))
    return env, dags


class FakeClock:
    def __init__(self, step: float = 0.001):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def fleet():
    return _fleet(port)


@pytest.fixture(scope="module")
def trace4(fleet):
    return port.sample_trace("wifi-fade", fleet[0], rounds=4, seed=3)


@pytest.fixture(scope="module")
def batch_report(fleet, trace4):
    return port.replan_fleet(fleet[1], trace4, RCFG, seed=7, device="cpu")


@pytest.fixture(scope="module")
def service_report(fleet, trace4):
    return port.run_service(fleet[1], trace4, port.ServiceConfig(
        replan=RCFG), seed=7, device="cpu")


# ---------------------------------------------------------------------------
# helpers of the loop
# ---------------------------------------------------------------------------

def test_rate_window():
    w = _RateWindow(window_rounds=2, horizon=10.0, n_apps=1)
    assert w.rate() is None
    w.ingest(np.array([0.1, 0.2, 0.3, 0.4, 0.5]))
    assert w.rate() == pytest.approx(0.5)
    w.ingest(np.concatenate([np.arange(15.0), [np.inf]]))
    assert w.rate() == pytest.approx(1.0)
    w.ingest(np.arange(15.0))
    assert w.rate() == pytest.approx(1.5)


def test_select_rung():
    assert port.LADDER_RUNGS == ref.LADDER_RUNGS
    assert _select_rung(float("inf"), 50, 10) == "warm"
    assert _select_rung(50.0, 50, 10) == "warm"
    assert _select_rung(49.9, 50, 10) == "burst"
    assert _select_rung(10.0, 50, 10) == "burst"
    assert _select_rung(9.9, 50, 10) == "pinned"


def test_config_validation_and_fields_match_reference():
    with pytest.raises(ValueError, match="p_crash"):
        port.ChaosConfig(p_crash=1.5)
    with pytest.raises(ValueError, match="stall_s"):
        port.ChaosConfig(stall_s=-1.0)
    for kw, match in (({"slo_s": 0.0}, "slo_s"),
                      ({"triage_margin": -1.0}, "triage_margin"),
                      ({"window_rounds": 0}, "window_rounds"),
                      ({"retries": -1}, "retries")):
        with pytest.raises(ValueError, match=match):
            port.ServiceConfig(**kw)
    for a, b in ((port.ServiceConfig, ref.ServiceConfig),
                 (port.ChaosConfig, ref.ChaosConfig)):
        fa = {f.name: f.default for f in dataclasses.fields(a)}
        fb = {f.name: f.default for f in dataclasses.fields(b)}
        assert fa.keys() == fb.keys()
        for k in fa:
            if k not in ("replan", "burst"):
                assert fa[k] == fb[k], k
    assert port.ServiceConfig().burst.max_iters == \
        ref.ServiceConfig().burst.max_iters
    assert port.ServiceRoundLog._fields == ref.ServiceRoundLog._fields


def test_service_report_helpers():
    def row(rung, wall):
        return port.ServiceRoundLog(
            round=1, label="x", rung=rung, wall_s=wall,
            budget_iters=float("inf"), breaker_state="closed",
            solver_failed=False, retries_used=0, stale_env=False,
            stalled=False, rejected_apps=0, est_rates=(), replan=None)
    rep = port.ServiceReport(cold=[], rounds=[row(("warm", "reject"), 1.0),
                                              row(("heft", "greedy"), 3.0)],
                             plans=[], fallback_counts={}, counters={})
    assert rep.availability() == pytest.approx(0.75)
    ttp = rep.time_to_plan()
    assert ttp["p50"] == pytest.approx(2.0) and ttp["max"] == 3.0
    assert rep.summary()["rounds"] == 2


def test_down_env_severs_links(fleet):
    env, dags = fleet
    s_last = env.num_servers - 1
    pr = port.SimProblem.build(dags[0], env)
    x = np.asarray(np.where(pr.pinned >= 0, pr.pinned, 0), np.int64)
    x[1] = s_last
    assert port.plan_is_valid(pr, x)
    down = _down_env(env, s_last)
    assert not port.plan_is_valid(port.SimProblem.build(dags[0], down), x)
    np.testing.assert_array_equal(
        down.bandwidth, ref_service._down_env(ref.paper_environment(),
                                              s_last).bandwidth)


# ---------------------------------------------------------------------------
# the parity invariant: protections off ⇒ replan_fleet, bit for bit
# ---------------------------------------------------------------------------

def test_service_matches_replan_fleet_bit_for_bit(batch_report,
                                                  service_report):
    assert len(service_report.rounds) == len(batch_report.rounds)
    for r, b in zip(service_report.rounds, batch_report.rounds):
        assert r.rung == ("warm",) * 2
        for f in ("cost", "replanned", "candidate_key", "incumbent_key",
                  "moved_layers", "iterations"):
            np.testing.assert_array_equal(getattr(r.replan, f),
                                          getattr(b, f), err_msg=f)
    for c_s, c_b in zip(service_report.cold, batch_report.cold):
        np.testing.assert_array_equal(c_s.best_x, c_b.best_x)
    for x_s, x_b in zip(service_report.plans, batch_report.plans):
        np.testing.assert_array_equal(x_s, x_b)
    assert service_report.availability() == 1.0
    assert service_report.counters["crashes"] == 0
    assert service_report.counters["stale_env_rounds"] == 0


def test_service_traffic_parity(fleet):
    env, dags = fleet
    trace = port.sample_trace("load-surge", env, rounds=3, seed=5)
    batch = port.replan_fleet(dags, trace, RCFG_T, seed=7, device="cpu")
    serv = port.run_service(dags, trace, port.ServiceConfig(replan=RCFG_T),
                            seed=7, device="cpu")
    for r, b in zip(serv.rounds, batch.rounds):
        np.testing.assert_array_equal(r.replan.cost, b.cost)
        np.testing.assert_array_equal(r.replan.candidate_key,
                                      b.candidate_key)
    for x_s, x_b in zip(serv.plans, batch.plans):
        np.testing.assert_array_equal(x_s, x_b)


def test_service_accepts_initial_plans(fleet, trace4, service_report):
    env, dags = fleet
    probs0 = [port.SimProblem.build(d, trace4.env_at(0)) for d in dags]
    cold = port.run_pso_ga_batch(probs0, FAST, seed=7, device="cpu")
    rep = port.run_service(dags, trace4, port.ServiceConfig(replan=RCFG),
                           seed=7, initial=cold, device="cpu")
    for x_s, x_b in zip(rep.plans, service_report.plans):
        np.testing.assert_array_equal(x_s, x_b)
    with pytest.raises(ValueError, match="initial"):
        port.run_service(dags, trace4, port.ServiceConfig(replan=RCFG),
                         seed=7, initial=cold[:1], device="cpu")


def test_on_round_sees_each_round_and_its_plans(fleet, trace4,
                                                service_report):
    seen = []
    rep = port.run_service(
        fleet[1], trace4, port.ServiceConfig(replan=RCFG), seed=7,
        initial=service_report.cold, device="cpu",
        on_round=lambda log, plans: seen.append(
            (log.round, [np.array(x) for x in plans])))
    assert [k for k, _ in seen] == [r.round for r in rep.rounds]
    for x_seen, x_end in zip(seen[-1][1], rep.plans):
        np.testing.assert_array_equal(x_seen, x_end)


# ---------------------------------------------------------------------------
# chaos harness
# ---------------------------------------------------------------------------

def test_chaos_crash_is_retried_transparently(fleet, trace4,
                                              service_report):
    sleeps = []
    cfg = port.ServiceConfig(replan=RCFG, backoff_s=0.05,
                             chaos=port.ChaosConfig(crash_rounds=(1,)))
    rep = port.run_service(fleet[1], trace4, cfg, seed=7,
                           sleeper=sleeps.append, device="cpu",
                           initial=service_report.cold)
    assert rep.counters["retries"] == 1 and rep.counters["crashes"] == 0
    assert rep.rounds[0].retries_used == 1
    np.testing.assert_allclose(sleeps, [0.05])
    for x_c, x_p in zip(rep.plans, service_report.plans):
        np.testing.assert_array_equal(x_c, x_p)


def test_chaos_persistent_crash_trips_breaker_and_pins(fleet,
                                                       service_report):
    env, dags = fleet
    trace = port.zero_drift_trace(env, rounds=6)
    cfg = port.ServiceConfig(replan=RCFG, retries=1, breaker_threshold=2,
                             breaker_cooldown=2,
                             chaos=port.ChaosConfig(p_crash=1.0))
    rep = port.run_service(dags, trace, cfg, seed=7, device="cpu",
                           initial=service_report.cold)
    assert rep.counters["crashes"] == 3
    assert rep.counters["breaker_opened"] == 2
    assert [r.breaker_state for r in rep.rounds] == \
        ["closed", "closed", "open", "open", "open"]
    assert all(r.rung == ("pinned",) * 2 for r in rep.rounds)
    assert rep.fallback_counts["pinned"] == 10
    assert rep.availability() == 1.0
    for d, x in zip(dags, rep.plans):
        assert port.plan_is_valid(port.SimProblem.build(d, env), x)


def test_chaos_nan_env_falls_back_to_last_good(fleet, trace4,
                                               service_report):
    cfg = port.ServiceConfig(replan=RCFG,
                             chaos=port.ChaosConfig(nan_env_rounds=(1,)))
    rep = port.run_service(fleet[1], trace4, cfg, seed=7, device="cpu",
                           initial=service_report.cold)
    assert rep.counters["stale_env_rounds"] == 1
    assert rep.rounds[0].stale_env and not rep.rounds[1].stale_env
    assert rep.availability() == 1.0
    for d, x in zip(fleet[1], rep.plans):
        assert port.plan_is_valid(port.SimProblem.build(d, trace4.env_at(3)),
                                  x)


def test_chaos_stall_is_flagged_and_pinned(fleet, service_report):
    """A 50 s stall is flagged and pinned; the next round solves. Fake-clock
    walls keep a loaded host from flagging another round."""
    env, dags = fleet
    trace = port.zero_drift_trace(env, rounds=5)
    cfg = port.ServiceConfig(replan=RCFG, straggler_warmup=2,
                             treat_stalls_as_failures=True,
                             chaos=port.ChaosConfig(stall_rounds=(3,),
                                                    stall_s=50.0))
    rep = port.run_service(dags, trace, cfg, seed=7, device="cpu",
                           initial=service_report.cold,
                           telemetry=port.Telemetry(clock=FakeClock()))
    assert rep.counters["stalls_flagged"] == 1
    assert rep.rounds[2].stalled and rep.rounds[2].solver_failed
    assert rep.rounds[2].rung == ("pinned",) * 2
    assert rep.rounds[2].wall_s > 50.0
    assert not rep.rounds[3].stalled and rep.rounds[3].rung == ("warm",) * 2


def test_chaos_compound_suite_stays_available(fleet):
    """Every fault class at once. The walls come from a fake clock: the
    straggler detector flags on walls, and measured ones on a loaded host
    can flag a second stall."""
    env, dags = fleet
    trace = port.sample_trace("node-loss", env, rounds=8, seed=2)
    cfg = port.ServiceConfig(
        replan=RCFG, retries=2, treat_stalls_as_failures=True,
        straggler_warmup=2,
        chaos=port.ChaosConfig(crash_rounds=(2,), nan_env_rounds=(3,),
                               stall_rounds=(5,), stall_s=25.0,
                               mid_round_down={6: env.num_servers - 1}))

    def run():
        return port.run_service(dags, trace, cfg, seed=7, device="cpu",
                                sleeper=lambda s: None,
                                telemetry=port.Telemetry(clock=FakeClock()))

    rep = run()
    assert rep.availability() >= 0.99
    assert sum(rep.fallback_counts.values()) == 7 * len(dags)
    assert rep.counters["stale_env_rounds"] == 1
    assert rep.counters["stalls_flagged"] == 1
    ttp = rep.time_to_plan()
    assert np.isfinite(ttp["p99"]) and ttp["p99"] > 0.0
    assert all(g in port.LADDER_RUNGS for r in rep.rounds for g in r.rung)
    assert rep.rounds[4].stalled and rep.rounds[4].rung == ("pinned",) * 2
    # determinism: the same chaos replays to the same plans and walls
    rep2 = run()
    for x1, x2 in zip(rep.plans, rep2.plans):
        np.testing.assert_array_equal(x1, x2)
    assert [r.wall_s for r in rep.rounds] == [r.wall_s for r in rep2.rounds]


def test_chaos_mid_round_node_loss_revalidates(fleet, service_report):
    env, dags = fleet
    s_last = env.num_servers - 1
    trace = port.zero_drift_trace(env, rounds=3)
    cfg = port.ServiceConfig(replan=RCFG, chaos=port.ChaosConfig(
        mid_round_down={2: s_last}))
    rep = port.run_service(dags, trace, cfg, seed=7, device="cpu",
                           initial=service_report.cold)
    assert rep.availability() == 1.0
    down = _down_env(env, s_last)
    for dag, x in zip(dags, rep.plans):
        assert x is not None
        assert port.plan_is_valid(port.SimProblem.build(dag, down), x)


# ---------------------------------------------------------------------------
# watchdog, triage, rate estimation
# ---------------------------------------------------------------------------

def test_watchdog_cuts_to_pinned_under_tiny_slo(fleet, trace4,
                                                service_report):
    cfg = port.ServiceConfig(replan=RCFG, burst=BURST, slo_s=1e-6)
    rep = port.run_service(fleet[1], trace4, cfg, seed=7, device="cpu",
                           initial=service_report.cold)
    assert rep.rounds[0].rung == ("warm",) * 2
    assert rep.rounds[0].budget_iters == float("inf")
    for r in rep.rounds[1:]:
        assert r.rung == ("pinned",) * 2 and r.replan is None
        assert r.budget_iters < BURST.max_iters
    assert rep.counters["watchdog_cuts"] == len(rep.rounds) - 1
    assert rep.availability() == 1.0


def test_triage_rejects_unsavable_apps():
    env, dags = _fleet(port, deadlines=(1.5, 1e-9))
    trace = port.zero_drift_trace(env, rounds=3)
    cfg = port.ServiceConfig(replan=RCFG_T, triage_margin=1.0)
    rep = port.run_service(dags, trace, cfg, seed=7, device="cpu")
    assert all(r.rejected_apps == 1 for r in rep.rounds)
    assert rep.counters["rejected_apps"] == 2
    assert rep.availability() == 1.0


def test_estimate_rates_records_per_dag_estimates(fleet):
    env, base = fleet
    dags = [base[0], port.merge_dags(list(base))]
    tc = port.TrafficConfig(rate=0.05, horizon=10.0, max_requests=4,
                            mc_solver=2, mc_eval=4)
    trace = port.sample_trace("load-surge", env, rounds=4, seed=5)
    cfg = port.ServiceConfig(replan=port.ReplanConfig(pso=FAST, traffic=tc),
                             estimate_rates=True, window_rounds=2)
    rep = port.run_service(dags, trace, cfg, seed=7, device="cpu")
    wins = [_RateWindow(2, tc.horizon, d.num_apps) for d in dags]
    for r in rep.rounds:
        assert r.rung == ("warm",) * 2
        expected = []
        for i, d in enumerate(dags):
            wins[i].ingest(tc.solver_arrivals(
                d.num_apps, seed=7 + 7919 * r.round + 31 * i,
                rate_scale=trace.events[r.round].load_scale)[0])
            expected.append(wins[i].rate())
        assert r.est_rates == pytest.approx(tuple(expected))
    assert any(r.est_rates[0] != r.est_rates[1] for r in rep.rounds)
    assert rep.availability() == 1.0


# ---------------------------------------------------------------------------
# run_services: each service equals its run alone
# ---------------------------------------------------------------------------

def test_run_services_equal_each_service_alone(fleet, service_report):
    env, dags = fleet
    trace = port.sample_trace("congestion", env, rounds=3, seed=1)
    cfgs = [port.ServiceConfig(replan=RCFG),
            port.ServiceConfig(replan=RCFG_T, estimate_rates=True,
                               chaos=port.ChaosConfig(crash_rounds=(1,)))]
    fleets = [dags, dags[::-1]]
    reports = port.run_services(fleets, trace, cfgs, seeds=[3, 4],
                                device="cpu")
    for j, rep in enumerate(reports):
        solo = port.run_service(fleets[j], trace, cfgs[j], seed=3 + j,
                                device="cpu")
        assert rep.counters == solo.counters
        assert [r.rung for r in rep.rounds] == [r.rung for r in solo.rounds]
        assert [r.est_rates for r in rep.rounds] == \
            [r.est_rates for r in solo.rounds]
        for x, y in zip(rep.plans, solo.plans):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the service logic of both packages around one shared stub solver
# ---------------------------------------------------------------------------

def _stub_solver(alt, calls):
    """A ``replan_round`` stand-in shared by both packages: fixed plans by
    round (keep the incumbent, switch to ``alt``, or a pin-breaking plan
    the ladder must catch), fixed iteration counts, a few clock ticks."""
    def stub(probs, incumbent, cfg, seed=0, round_no=0, label="",
             arrivals=None, telemetry=None, **kw):
        calls.append((round_no, seed, label, cfg.pso.max_iters,
                      None if arrivals is None else
                      [np.asarray(a).tolist() for a in arrivals]))
        for _ in range(round_no % 3 + 1):
            telemetry.clock()
        plans = []
        for i, (pr, inc) in enumerate(zip(probs, incumbent)):
            pick = (round_no + i) % 3
            if pick == 0 and inc is not None:
                plans.append(np.asarray(inc, np.int32))
            elif pick == 2 and round_no % 4 == 1:
                bad = np.array(alt[i], np.int32)
                bad[0] = (bad[0] + 1) % pr.num_servers      # breaks the pin
                plans.append(bad)
            else:
                plans.append(np.array(alt[i], np.int32))
        log = types.SimpleNamespace(
            iterations=np.full(len(probs), 40 + round_no, np.int64),
            demoted=np.array([inc is None for inc in incumbent]))
        return plans, log
    return stub


def _stub_run(lib, service_mod, monkeypatch, alt, init):
    env, dags = _fleet(lib)
    dags.append(dags[0].with_deadline(np.array([1e-9])))  # triaged out
    calls = []
    monkeypatch.setattr(service_mod, "replan_round",
                        _stub_solver(alt, calls))
    pso = lib.PSOGAConfig(pop_size=20, max_iters=50, stall_iters=18)
    tc = lib.TrafficConfig(rate=0.4, max_requests=4, mc_solver=2,
                           mc_eval=4)
    cfg = lib.ServiceConfig(
        replan=lib.ReplanConfig(pso=pso, traffic=tc),
        burst=lib.PSOGAConfig(pop_size=12, max_iters=10, stall_iters=6),
        slo_s=2.6e-3, triage_margin=1.0, estimate_rates=True,
        window_rounds=3, retries=1, breaker_threshold=1,
        breaker_cooldown=2, treat_stalls_as_failures=True,
        straggler_warmup=2, plan_cache=lib.PlanCacheConfig(),
        ingest=lib.IngestConfig(threads=0, capacity=2),
        chaos=lib.ChaosConfig(crash_rounds=(2,), p_crash=0.4, seed=5,
                              max_crashes=4, nan_env_rounds=(4,),
                              stall_rounds=(6,), stall_s=5.0,
                              mid_round_down={7: 3}))
    trace = lib.sample_trace("node-loss", env, rounds=11, seed=6)
    tel = lib.Telemetry(clock=FakeClock())
    sleeps = []
    initial = [types.SimpleNamespace(best_x=x) for x in init]
    rep = service_mod.run_service(dags, trace, cfg, seed=9,
                                  initial=initial, sleeper=sleeps.append,
                                  telemetry=tel)
    return rep, tel, calls, sleeps


def test_service_logic_equals_reference_around_a_shared_stub(monkeypatch,
                                                             tmp_path):
    """A 10-round chaos suite (crash, random crashes, NaN env, stall,
    mid-round churn on a node-loss trace) with a fake clock, the plan
    cache, triage and queued rate estimation (``threads=0``), the
    solver stubbed out in both packages: every decision the service
    makes, every wall and every telemetry export are equal."""
    env, dags = _fleet(port)
    alt = [np.asarray(port.heft_makespan(d, env)[1], np.int32)
           for d in dags]
    alt.append(alt[0])
    init = [np.asarray(port.greedy_offload(d, env).best_x, np.int32)
            for d in dags]
    init.append(init[0])
    a, tel_a, calls_a, sleeps_a = _stub_run(ref, ref_service, monkeypatch,
                                            alt, init)
    b, tel_b, calls_b, sleeps_b = _stub_run(port, port_service,
                                            monkeypatch, alt, init)
    assert calls_b == calls_a and sleeps_b == sleeps_a
    assert len(b.rounds) == 10
    fields = [f for f in port.ServiceRoundLog._fields if f != "replan"]
    for ra, rb in zip(a.rounds, b.rounds):
        for f in fields:
            assert getattr(rb, f) == getattr(ra, f), (ra.round, f)
        assert (rb.replan is None) == (ra.replan is None)
    assert b.counters == a.counters
    assert b.fallback_counts == a.fallback_counts
    assert b.cache_stats == a.cache_stats
    for xa, xb in zip(a.plans, b.plans):
        assert (xa is None) == (xb is None)
        if xa is not None:
            assert xb.dtype == xa.dtype and np.array_equal(xa, xb)
    assert b.summary() == a.summary()
    # the reference's runner_cache.* gauges count JAX's compiled runners
    # and have no counterpart in the port
    for export in ("to_jsonl", "to_prometheus"):
        want = [ln for ln in getattr(tel_a.registry, export)().splitlines()
                if "runner_cache" not in ln]
        assert getattr(tel_b.registry, export)().splitlines() == want
    assert tel_b.tracer.to_chrome_trace() == tel_a.tracer.to_chrome_trace()
    # the suite reaches every branch it claims to
    rungs = {g for r in b.rounds for g in r.rung}
    assert {"cached", "warm", "burst", "pinned", "heft"} <= rungs, rungs
    assert b.counters["stale_env_rounds"] == 1
    assert b.counters["stalls_flagged"] == 1
    assert b.counters["crashes"] >= 1 and b.counters["retries"] >= 1
    assert b.counters["rejected_apps"] > 0
    assert b.counters["ingest_dropped"] > 0
    assert b.cache_stats["hits"] > 0
    assert any(r.breaker_state == "open" for r in b.rounds)


# ---------------------------------------------------------------------------
# compound rescue (tests/test_service_properties.py's seeded sweep)
# ---------------------------------------------------------------------------

TINY = port.PSOGAConfig(pop_size=12, max_iters=24, stall_iters=10)
TP = port.TrafficConfig(rate=0.5, max_requests=3, mc_solver=1, mc_eval=2)


def compound_case(seed: int):
    """Two random pinned DAGs + a 2-round trace whose drift round churns
    out a (non-pinned) server AND surges the arrival rate."""
    rng = np.random.default_rng(seed)
    env = port.paper_environment()
    s = env.num_servers
    dags = []
    for _ in range(2):
        p = int(rng.integers(4, 9))
        edges, mbs = [], []
        for j in range(1, p):
            parents = rng.choice(j, size=min(j, int(rng.integers(1, 3))),
                                 replace=False)
            for u in parents:
                edges.append((int(u), j))
                mbs.append(float(rng.uniform(0.01, 1.0)))
        pinned = np.full(p, -1, np.int32)
        devices = np.nonzero(np.asarray(env.tier) == 2)[0]
        pinned[0] = int(rng.choice(devices))
        dag = LayerDAG(compute=rng.uniform(0.05, 2.0, p),
                       edges=np.asarray(edges, np.int32).reshape(-1, 2),
                       edge_mb=np.asarray(mbs),
                       app_id=np.zeros(p, np.int32),
                       deadline=np.asarray([np.inf]), pinned=pinned)
        h, _ = port.heft_makespan(dag, env)
        dl = float(rng.choice([1.5, 3.0, 8.0])) * h
        dags.append(dag.with_deadline(np.asarray([dl])))
    pinned_servers = {int(d.pinned[0]) for d in dags}
    down = np.zeros(s, bool)
    down[int(rng.choice([i for i in range(s)
                         if i not in pinned_servers]))] = True
    surge = float(rng.uniform(1.5, 3.0))
    ev = port.DriftEvent(t=60.0, label=f"compound[{surge:.2f}]",
                         bw_scale=np.ones((s, s)), power_scale=np.ones(s),
                         price_scale=np.ones(s), down=down,
                         load_scale=surge)
    trace = port.EnvTrace(base=env,
                          events=(_identity_event(s, 0.0, "base"), ev))
    return dags, trace


@pytest.mark.parametrize("traffic", [True, False])
def test_compound_rescue_sweep(traffic):
    """Over seeded random fleets: surviving plans are well-formed and
    honor pins, feasible ones pass the full stale-plan guard under the
    churned environment, and the logged cost is reproduced by an
    independent replay (``incumbent_keys`` under the round's draws, or
    ``simulate_np`` at zero load)."""
    for seed in range(8 if traffic else 6):
        dags, trace = compound_case(seed)
        cfg = port.ReplanConfig(pso=TINY, traffic=TP if traffic else None)
        rep = port.replan_fleet(dags, trace, cfg, seed=seed, device="cpu")
        log = rep.rounds[0]
        probs = [port.SimProblem.build(d, trace.env_at(1)) for d in dags]
        for i, (pr, x) in enumerate(zip(probs, rep.plans)):
            x = np.asarray(x)
            assert x.shape == (pr.num_layers,)
            assert np.all((x >= 0) & (x < pr.num_servers))
            pin = np.asarray(pr.pinned) >= 0
            assert np.all(x[pin] == np.asarray(pr.pinned)[pin])
            if log.feasible[i]:
                assert port.plan_is_valid(pr, x)
            else:
                assert not np.isfinite(log.cost[i])
        if traffic:
            arr = _round_arrivals(cfg, dags, trace.events[1], seed + 1000)
            keys = port.incumbent_keys(probs, list(rep.plans), TINY,
                                       arrivals=arr, device="cpu")
            for i in range(len(dags)):
                if log.feasible[i]:
                    assert keys[i] == pytest.approx(float(log.cost[i]),
                                                    rel=1e-5)
                else:
                    assert keys[i] >= port.INFEASIBLE_OFFSET
        else:
            for i, (pr, x) in enumerate(zip(probs, rep.plans)):
                if log.feasible[i]:
                    replay = port.simulate_np(pr, np.asarray(x, np.int64),
                                              faithful=TINY.faithful_sim)
                    assert float(log.cost[i]) == pytest.approx(
                        float(replay.total_cost), rel=1e-6)


# ---------------------------------------------------------------------------
# the CLI: serve --plan --serve
# ---------------------------------------------------------------------------

def test_serve_cli_runs_the_service_and_exports_a_valid_trace(tmp_path,
                                                              capsys):
    from repro_torch.launch import serve
    trace, metrics = tmp_path / "t.json", tmp_path / "m"
    serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--pop", "8",
                "--iters", "5", "--plan", "--serve", "congestion",
                "--serve-rounds", "4", "--chaos", "--plan-cache",
                "--trace-out", str(trace), "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    rounds = [ln for ln in out.splitlines() if "service round" in ln]
    assert [ln.split()[3] for ln in rounds] == ["1", "2", "3"]
    assert "[serve] service: 3 rounds, availability 1.0000" in out
    assert "[serve] plan cache: hit rate" in out
    assert "[serve] first row" not in out       # the LM is not served
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "check_trace.py")
    spec = importlib.util.spec_from_file_location("check_trace", path)
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    assert ct.check_trace(str(trace), require=[
        "round", "solve", "cache_lookup", "ladder", "replan_round",
        "fleet_solve"]) > 0
    ct.check_metrics(str(metrics))


@pytest.mark.parametrize("argv,match", [
    (["--serve", "congestion"], "--serve requires --plan"),
    (["--metrics-out", "m"], "require --plan"),
    (["--plan", "--serve", "bursty", "--traffic", "poisson"], "conflicts"),
    (["--plan", "--serve", "load-surge"], "only exists with --traffic"),
    (["--plan", "--serve", "congestion", "--estimate-rates"],
     "need --traffic"),
    (["--plan", "--serve", "bursty", "--async-ingest", "1"],
     "needs --estimate-rates"),
    (["--plan", "--serve", "bursty", "--estimate-rates", "--async-ingest",
      "-1"], ">= 0"),
    (["--plan", "--serve", "congestion", "--serve-rounds", "0"], ">= 1"),
])
def test_serve_cli_checks_its_arguments(argv, match, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen3-0.6b", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


def test_serve_bursty_means_traffic_bursty_through_load_surge():
    import argparse

    from repro_torch.launch import plan
    ap = argparse.ArgumentParser()
    plan.add_plan_args(ap)
    args = ap.parse_args(["--serve", "bursty"])
    plan.check_plan_args(ap, args)
    assert (args.traffic, args.serve_scenario) == ("bursty", "load-surge")
