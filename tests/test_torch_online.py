"""Online re-planning in the port against the reference
(``tests/test_online.py``, mirrored): drift traces bit for bit, the
migration term, the stale-plan guard, incumbent keys, incumbent and rescue
seeding, the warm fleet solve and one replan round fed the reference's own
warm swarms and draws, and the zero-drift parity invariant."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_parity import (CPU, RTOL, RefDraws, legacy_stream, np_of,
                               port_cfg)

import repro.core as ref
import repro.core.online as ref_online
import repro_torch.core as port
from repro.core.pso_ga import init_swarm as ref_init_swarm

torch.set_num_threads(1)

#: sizes no other test uses, so the reference's cached fleet runners for
#: them are compiled here, under the legacy stream
CFG_REF = ref.PSOGAConfig(pop_size=16, max_iters=30, stall_iters=10)
CFG = port_cfg(CFG_REF)


def _fleet(lib, nets=("alexnet", "googlenet", "alexnet"), ratio=1.5):
    env = lib.paper_environment()
    dags = []
    for i, net in enumerate(nets):
        dag = lib.zoo.build(net, pin_server=i)
        h, _ = lib.heft_makespan(dag, env)
        dags.append(dag.with_deadline(np.array([ratio * h])))
    return env, dags


# ---------------------------------------------------------------------------
# traces: numpy copies, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_name", ["paper_environment",
                                      "tpu_fleet_environment"])
@pytest.mark.parametrize("kind", port.TRACE_KINDS)
def test_sample_trace_equals_reference(kind, env_name):
    assert port.TRACE_KINDS == ref.TRACE_KINDS
    a = ref.sample_trace(kind, getattr(ref, env_name)(), rounds=5, seed=3)
    b = port.sample_trace(kind, getattr(port, env_name)(), rounds=5, seed=3)
    assert a.num_rounds == b.num_rounds == 5
    for k, (ea, eb) in enumerate(zip(a.events, b.events)):
        for f in dataclasses.fields(ref.DriftEvent):
            va, vb = getattr(ea, f.name), getattr(eb, f.name)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        assert ea.is_identity() == eb.is_identity()
        xa, xb = a.env_at(k), b.env_at(k)
        for field in ("power", "cost_per_sec", "tier", "bandwidth",
                      "tran_cost"):
            va, vb = getattr(xa, field), getattr(xb, field)
            assert va.shape == vb.shape and va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb, err_msg=field)


def test_zero_drift_trace_is_identity():
    env = port.paper_environment()
    trace = port.zero_drift_trace(env, rounds=3)
    want = ref.zero_drift_trace(ref.paper_environment(), rounds=3)
    assert trace.num_rounds == want.num_rounds == 3
    for k in range(3):
        assert trace.events[k].is_identity()
        assert trace.events[k].label == want.events[k].label
        assert trace.events[k].t == want.events[k].t
        e = trace.env_at(k)
        for field in ("power", "cost_per_sec", "bandwidth", "tran_cost"):
            np.testing.assert_array_equal(getattr(e, field),
                                          getattr(env, field))


def test_node_loss_never_strands_pinned_home_servers():
    env = port.paper_environment()
    device = np.asarray(env.tier) == port.DEVICE
    for seed in range(5):
        trace = port.sample_trace("node-loss", env, rounds=5, seed=seed)
        for k in range(1, trace.num_rounds):
            ev = trace.events[k]
            assert ev.down.sum() == 1 and not ev.down[device].any()
            e = trace.env_at(k)
            alive = ~(ev.down[:, None] | ev.down[None, :])
            np.testing.assert_array_equal(e.bandwidth[alive],
                                          env.bandwidth[alive])
            off = ~np.eye(env.num_servers, dtype=bool)
            assert (e.bandwidth[~alive & off] == 0.0).all()


def test_load_surge_drifts_workload_not_environment():
    env = port.paper_environment()
    trace = port.sample_trace("load-surge", env, rounds=5, seed=3)
    assert trace.events[0].load_scale == 1.0
    surged = False
    for k in range(trace.num_rounds):
        e = trace.env_at(k)
        for field in ("bandwidth", "power", "cost_per_sec"):
            np.testing.assert_array_equal(getattr(e, field),
                                          getattr(env, field))
        assert trace.events[k].load_scale >= 1.0
        surged |= trace.events[k].load_scale > 1.0
    assert surged


def test_malformed_events_and_traces_rejected():
    s = port.paper_environment().num_servers
    ok = dict(t=0.0, label="x", bw_scale=np.ones((s, s)),
              power_scale=np.ones(s), price_scale=np.ones(s),
              down=np.zeros(s, bool))
    for bad in (dict(bw_scale=np.ones((s, s - 1))),
                dict(power_scale=np.full(s, np.nan)),
                dict(price_scale=-np.ones(s)), dict(t=-1.0),
                dict(load_scale=0.0)):
        for lib in (ref, port):
            with pytest.raises(ValueError):
                lib.DriftEvent(**{**ok, **bad})
    with pytest.raises(ValueError):
        port.sample_trace("meteor-strike", port.paper_environment(), 2)
    with pytest.raises(ValueError):
        port.EnvTrace(base=port.paper_environment(), events=())


def test_config_and_log_fields_match_reference():
    """``RoundLog``, ``OnlineReport`` and ``ReplanConfig`` keep the
    reference's fields (``mesh`` a ``DeviceMesh``, ``None`` by default:
    one device)."""
    assert port.RoundLog._fields == ref.RoundLog._fields
    assert [f.name for f in dataclasses.fields(port.OnlineReport)] == \
        [f.name for f in dataclasses.fields(ref.OnlineReport)]
    assert [f.name for f in dataclasses.fields(port.ReplanConfig)] == \
        [f.name for f in dataclasses.fields(ref.ReplanConfig)]
    a, b = ref.ReplanConfig(), port.ReplanConfig()
    assert b.migration_weight == a.migration_weight and b.traffic is None
    assert b.mesh is None
    assert port_cfg(a.pso) == b.pso
    report = port.OnlineReport(
        cold=[port.PSOGAResult(np.zeros(2, np.int32), 1.0, 1.0, True, 1)],
        rounds=[], plans=[np.zeros(2, np.int32)])
    assert report.total_cost() == 1.0


# ---------------------------------------------------------------------------
# migration term and stale-plan guard
# ---------------------------------------------------------------------------

def test_migration_cost_agrees_with_reference(rng):
    env_r, env_p = ref.sample_environment(), port.sample_environment()
    dag_r = ref.zoo.alexnet(pin_server=0, deadline=6.0)
    dag_p = port.zoo.alexnet(pin_server=0, deadline=6.0)
    pr, pt = ref.SimProblem.build(dag_r, env_r), \
        port.SimProblem.build(dag_p, env_p)
    p = dag_p.num_layers
    pp_r = ref.pad_problem(pr, max_p=16)
    pp_p = port.pad_problem(pt, max_p=16, device=CPU)
    for _ in range(5):
        old = rng.integers(0, env_p.num_servers, size=16).astype(np.int32)
        X = rng.integers(0, env_p.num_servers, size=(4, 16)).astype(np.int32)
        old[p:] = X[:, p:] = 0
        X[0] = old                                   # one unmoved particle
        want = np.asarray(ref.migration_cost(pp_r, X, old))
        got = np_of(port.migration_cost(pp_p, torch.as_tensor(X),
                                        torch.as_tensor(old)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert got[0] == 0.0
        for x in X:
            np.testing.assert_allclose(
                port.migration_cost_np(pt, old[:p], x[:p]),
                ref_online.migration_cost_np(pr, old[:p], x[:p]), rtol=0)


def _churned(lib, env, victim):
    """``env`` with every link of server ``victim`` severed (node loss)."""
    s = env.num_servers
    down = np.zeros(s, bool)
    down[victim] = True
    ev = lib.DriftEvent(t=0.0, label="x", bw_scale=np.ones((s, s)),
                        power_scale=np.ones(s), price_scale=np.ones(s),
                        down=down)
    return lib.EnvTrace(base=env, events=(ev,)).env_at(0)


def test_plan_is_valid_agrees_with_reference():
    """The stale-plan guard on a NaN-poisoned plan, a wrong-length and a
    2-d one, an out-of-range server, a broken pin, and a good plan on a
    churned server's severed links; an integral float plan passes."""
    env_r, dags_r = _fleet(ref, nets=("googlenet",))
    env_p, dags_p = _fleet(port, nets=("googlenet",))
    pr = ref.SimProblem.build(dags_r[0], env_r)
    pt = port.SimProblem.build(dags_p[0], env_p)
    good = np.asarray(port.greedy_offload(dags_p[0], env_p).best_x,
                      np.int32)
    nan = good.astype(float)
    nan[1] = np.nan
    pin = good.copy()
    pin[0] = (pin[0] + 1) % pt.num_servers
    out = good.copy()
    out[1] = pt.num_servers
    plans = {"good": good, "float-ok": good.astype(float), "nan": nan,
             "short": good[:-1], "2d": good[None], "range": out, "pin": pin}
    for name, plan in plans.items():
        want = name in ("good", "float-ok")
        assert port.plan_is_valid(pt, plan) == want, name
        assert ref.plan_is_valid(pr, plan) == want, name
    victim = int(next(s for s in good if env_p.tier[s] != port.DEVICE))
    assert not port.plan_is_valid(
        port.SimProblem.build(dags_p[0], _churned(port, env_p, victim)),
        good)
    assert not ref.plan_is_valid(
        ref.SimProblem.build(dags_r[0], _churned(ref, env_r, victim)), good)


# ---------------------------------------------------------------------------
# incumbent keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traffic", [False, True])
def test_incumbent_keys_match_reference(traffic):
    """Zero-load and traffic keys of incumbents (one of them demoted to
    ``None``) against the reference, rtol 1e-5; the zero-load keys of
    feasible plans equal their ``simulate_np`` replay."""
    env_r, dags_r = _fleet(ref)
    env_p, dags_p = _fleet(port)
    probs_r = [ref.SimProblem.build(d, env_r) for d in dags_r]
    probs_p = [port.SimProblem.build(d, env_p) for d in dags_p]
    incs = [np.asarray(port.greedy_offload(d, env_p).best_x, np.int32)
            for d in dags_p[:2]] + [None]
    arr = None
    if traffic:
        tc = port.TrafficConfig(kind="bursty", rate=0.5)
        arr = [tc.solver_arrivals(1, seed=31 * i) for i in range(3)]
    want = ref_online.incumbent_keys(probs_r, incs, CFG_REF, arrivals=arr)
    got = port.incumbent_keys(probs_p, incs, CFG, arrivals=arr, device=CPU)
    assert np.isinf(got[2]) and np.isinf(want[2])
    np.testing.assert_allclose(got[:2], want[:2], rtol=RTOL)
    if not traffic:
        for pr, inc, k in zip(probs_p[:2], incs, got):
            r = port.simulate_np(pr, inc, faithful=CFG.faithful_sim)
            assert bool(r.feasible) == (k < port.INFEASIBLE_OFFSET)
            if bool(r.feasible):
                np.testing.assert_allclose(k, r.total_cost, rtol=RTOL)


# ---------------------------------------------------------------------------
# incumbent seeding and the warm fleet solve
# ---------------------------------------------------------------------------

def test_init_swarm_incumbent_and_rescue_modes():
    """The port's own warm draws: exact elite clones, neighborhood genes
    inside each layer's reachable servers, rescue anchors at the tail by
    descending power, pins everywhere; no incumbent is the cold draw."""
    env = port.paper_environment()
    dag = port.zoo.googlenet(pin_server=0, deadline=10.0)
    prob = port.SimProblem.build(dag, env)
    cfg = port.PSOGAConfig(pop_size=40)
    inc = np.full(dag.num_layers, 11, np.int32)
    inc[0] = 0                                   # honor the pin

    def swarm(**kw):
        return np_of(port.init_swarm(prob, cfg, torch.Generator()
                                     .manual_seed(0), device=CPU, **kw))
    X = swarm(incumbent=inc)
    n_elite = cfg.warm_elite
    n_neigh = int(round(cfg.warm_fraction * cfg.pop_size))
    assert X.shape == (40, dag.num_layers) and X.dtype == np.int32
    assert (X[:n_elite] == inc).all()
    neigh = X[n_elite:n_elite + n_neigh]
    moved = neigh != inc
    assert 0 < moved.mean() <= 3 * cfg.warm_mutation + 0.05
    home = np.zeros(dag.num_layers, np.int64)
    reach = prob.link_ok[home] | (np.arange(prob.num_servers) == 0)
    cols = np.broadcast_to(np.arange(dag.num_layers), neigh.shape)
    assert reach[cols[moved], neigh[moved]].all()
    tail = X[n_elite + n_neigh:]
    assert (tail != inc).mean() > 0.3             # diversity kept
    assert (X[:, 0] == 0).all()
    Xr = swarm(incumbent=inc, rescue=True)
    t0 = n_elite + n_neigh
    by_power = np.argsort(-env.power, kind="stable")
    assert (Xr[t0][1:] == 0).all()                # all-home anchor
    for k in range(min(prob.num_servers, cfg.pop_size - t0 - 1)):
        assert (Xr[t0 + 1 + k][1:] == by_power[k]).all()
    np.testing.assert_array_equal(Xr[:t0], X[:t0])
    np.testing.assert_array_equal(swarm(), swarm(incumbent=None))


def _warm_inputs(lib, env, dags):
    """Incumbents for the fleet: the greedy plan of problem 0, a plan of
    the cold solve of problem 1 with two genes moved, and ``None``."""
    res = [lib.greedy_offload(d, env) for d in dags]
    inc1 = np.asarray(res[1].best_x, np.int32).copy()
    inc1[5:7] = (inc1[5:7] + 3) % env.num_servers
    return [np.asarray(res[0].best_x, np.int32), inc1, None]


def _ref_warm_X0(probs_r, incs, rescue, seed):
    with legacy_stream():
        out = []
        for pr, inc, res in zip(probs_r, incs, rescue):
            _, k_init = jax.random.split(jax.random.PRNGKey(seed))
            out.append(np.asarray(ref_init_swarm(
                k_init, pr, CFG_REF, incumbent=inc, rescue=bool(res))))
    return out


def test_warm_batch_fed_reference_swarms_matches_gene_for_gene():
    """``run_pso_ga_batch(incumbent=, migration_weight=, warm_rescue=)``
    fed the reference's warm swarms (``init_swarm``'s incumbent and rescue
    modes, one cold) and step draws: gene for gene, with per-problem
    weights; ``return_state`` keeps padded genes at 0."""
    env_r, dags_r = _fleet(ref)
    env_p, dags_p = _fleet(port)
    probs_r = [ref.SimProblem.build(d, env_r) for d in dags_r]
    incs = _warm_inputs(port, env_p, dags_p)
    mig, rescue = [0.5, 2.0, 1.0], [False, True, False]
    with legacy_stream():
        want = ref.run_pso_ga_batch(probs_r, CFG_REF, seed=4, incumbent=incs,
                                    migration_weight=mig, warm_rescue=rescue)
    draws = RefDraws(probs_r, CFG_REF, [4] * 3)
    got, state = port.run_pso_ga_batch(
        [(d, env_p) for d in dags_p], CFG, seed=4, device=CPU,
        X0=_ref_warm_X0(probs_r, incs, rescue, 4), draw_fn=draws,
        incumbent=incs, migration_weight=mig, warm_rescue=rescue,
        return_state=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.best_x, np.asarray(w.best_x))
        assert (g.iterations, g.feasible) == (w.iterations, w.feasible)
        np.testing.assert_allclose(g.best_fitness, w.best_fitness, rtol=RTOL)
        np.testing.assert_allclose(g.best_cost, w.best_cost, rtol=RTOL)
    assert state.X.shape[0] == 3
    for i, d in enumerate(dags_p):
        assert (np_of(state.X[i])[:, d.num_layers:] == 0).all()
        np.testing.assert_array_equal(np_of(state.gbest_x[i])[:d.num_layers],
                                      got[i].best_x)
    assert np_of(state.it).tolist() == [r.iterations for r in got]


def test_zero_weight_warm_key_is_the_cold_key():
    """A warm solve with migration weight 0 scores exactly as cold: its
    key is its winner's cold key bit for bit; a huge weight keeps the
    incumbent."""
    env, dags = _fleet(port, nets=("alexnet",))
    cold = port.run_pso_ga_batch([(dags[0], env)], CFG, seed=0,
                                 device=CPU)[0]
    inc = np.asarray(cold.best_x, np.int32)
    free = port.run_pso_ga_batch([(dags[0], env)], CFG, seed=1, device=CPU,
                                 incumbent=[inc], migration_weight=0.0)[0]
    key = port.incumbent_keys([port.SimProblem.build(dags[0], env)],
                              [free.best_x], CFG, device=CPU)[0]
    assert key == free.best_fitness
    heavy = port.run_pso_ga_batch([(dags[0], env)], CFG, seed=1, device=CPU,
                                  incumbent=[inc], migration_weight=1e6)[0]
    np.testing.assert_array_equal(heavy.best_x, inc)


def test_run_pso_ga_batch_incumbent_validation():
    env, dags = _fleet(port)
    probs = [port.SimProblem.build(d, env) for d in dags]
    with pytest.raises(ValueError, match="1 incumbents for 3 problems"):
        port.run_pso_ga_batch(probs, CFG, device=CPU,
                              incumbent=[np.zeros(3, np.int32)])
    with pytest.raises(ValueError, match="4 incumbents for 3 problems"):
        port.run_pso_ga_batch(probs, CFG, device=CPU,
                              incumbent=[np.zeros(3, np.int32)] * 4)
    with pytest.raises(ValueError, match=r"incumbent\[1\] has shape \(3,\)"):
        port.run_pso_ga_batch(probs, CFG, device=CPU, incumbent=[
            None, np.zeros(3, np.int32), None])


# ---------------------------------------------------------------------------
# the replan loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traffic", [False, True])
def test_replan_round_fed_reference_draws(traffic):
    """One round after a node loss that severs a server the incumbents
    use, with a NaN-poisoned incumbent and a wrong-length one beside them:
    fed the reference's warm swarms and draws, the port decides as the
    reference does (replanned, demoted, moved layers, iterations, plans),
    keys and costs to rtol 1e-5."""
    nets = ("alexnet", "googlenet", "alexnet", "googlenet")
    env_r, dags_r = _fleet(ref, nets=nets)
    env_p, dags_p = _fleet(port, nets=nets)
    cold = [port.greedy_offload(d, env_p).best_x for d in dags_p]
    # a rented server of plan 1 that plan 0 does not use
    victim = int(next(s for s in cold[1] if env_p.tier[s] != port.DEVICE
                      and s not in cold[0]))
    env_k, renv_k = _churned(port, env_p, victim), _churned(ref, env_r,
                                                            victim)
    nan = cold[2].astype(float)
    nan[3] = np.nan
    incs = [cold[0], cold[1], nan, cold[3][:-1]]
    probs_r = [ref.SimProblem.build(d, renv_k) for d in dags_r]
    probs_p = [port.SimProblem.build(d, env_k) for d in dags_p]
    arr = None
    if traffic:
        tc = port.TrafficConfig(kind="bursty", rate=0.5)
        arr = [tc.solver_arrivals(1, seed=31 * i) for i in range(4)]
    cfg_ref = ref.ReplanConfig(pso=CFG_REF, migration_weight=0.1)
    with legacy_stream():
        want_plans, want = ref.replan_round(probs_r, incs, cfg_ref, seed=6,
                                            round_no=1, label="x",
                                            arrivals=arr)
    assert want.demoted.tolist() == [False, True, True, True]
    rescue = want.incumbent_key >= ref.fitness.INFEASIBLE_OFFSET
    checked = [None if d else np.asarray(i, np.int32)
               for i, d in zip(incs, want.demoted)]
    draws = RefDraws(probs_r, CFG_REF, [6] * 4)
    plans, log = port.replan_round(
        probs_p, incs, port.ReplanConfig(pso=CFG, migration_weight=0.1),
        seed=6, round_no=1, label="x", arrivals=arr, device=CPU,
        X0=_ref_warm_X0(probs_r, checked, rescue, 6), draw_fn=draws)
    for field in ("replanned", "demoted", "moved_layers", "iterations",
                  "converge_iters", "feasible"):
        np.testing.assert_array_equal(getattr(log, field),
                                      getattr(want, field), err_msg=field)
    for field in ("incumbent_key", "candidate_key", "cost", "migration"):
        np.testing.assert_allclose(getattr(log, field), getattr(want, field),
                                   rtol=RTOL, err_msg=field)
    for got_x, want_x in zip(plans, want_plans):
        np.testing.assert_array_equal(got_x, np.asarray(want_x))
    assert (log.round, log.label) == (1, "x") and log.wall_s > 0
    # demoted problems pay no migration and count the full plan as moved
    assert (log.migration[1:] == 0).all()
    assert log.moved_layers[1:].tolist() == [d.num_layers
                                             for d in dags_p[1:]]
    # every surviving plan is a valid plan under the churned environment
    assert all(port.plan_is_valid(pr, x) for pr, x in zip(probs_p, plans))


def test_zero_drift_replan_fleet_keeps_incumbents_bit_for_bit():
    """The reference's warm-start parity bar: a zero-drift round keeps
    every incumbent, whose key is its cold key bit for bit. Later
    zero-drift rounds (other seeds) may still find a strictly better plan
    near an incumbent; they accept nothing else."""
    env, dags = _fleet(port)
    cfg = port.ReplanConfig(pso=CFG)
    trace = port.zero_drift_trace(env, rounds=3)
    cold = port.run_pso_ga_batch(
        [port.SimProblem.build(d, env) for d in dags], CFG, seed=0,
        device=CPU)
    seen = []
    report = port.replan_fleet(dags, trace, cfg, seed=0, initial=cold,
                               device=CPU,
                               on_round=lambda log, plans: seen.append(
                                   (log, plans)))
    assert [log.round for log, _ in seen] == [1, 2]
    assert report.rounds == [log for log, _ in seen]
    assert seen[-1][1] == report.plans
    first = report.rounds[0]
    assert not first.replanned.any() and not first.demoted.any()
    np.testing.assert_array_equal(first.incumbent_key,
                                  [r.best_fitness for r in cold])
    for log in report.rounds:
        assert (log.candidate_key[log.replanned]
                < log.incumbent_key[log.replanned]).all()
    for i, r in enumerate(cold):
        if not any(log.replanned[i] for log in report.rounds):
            np.testing.assert_array_equal(report.plans[i], r.best_x)
    assert report.total_cost() == float(np.sum(report.rounds[-1].cost))


def test_node_loss_forces_migration_off_dead_server():
    env, dags = _fleet(port)
    cfg = port.ReplanConfig(pso=CFG, migration_weight=0.1)
    cold = port.run_pso_ga_batch(
        [port.SimProblem.build(d, env) for d in dags], CFG, seed=0,
        device=CPU)
    used = [s for r in cold for s in np.unique(r.best_x)
            if env.tier[s] != port.DEVICE]
    assert used, "the cold plans must rent a server for this test"
    victim = int(used[0])
    trace = port.zero_drift_trace(env, rounds=2)
    down = np.zeros(env.num_servers, bool)
    down[victim] = True
    trace = dataclasses.replace(trace, events=(trace.events[0],
                                               dataclasses.replace(
                                                   trace.events[1],
                                                   down=down)))
    report = port.replan_fleet(dags, trace, cfg, seed=0, initial=cold,
                               device=CPU)
    (log,) = report.rounds
    for i, r in enumerate(cold):
        if victim in r.best_x:
            assert victim not in report.plans[i]
            assert log.replanned[i] and log.demoted[i]
        assert log.feasible[i]


def test_drift_replan_accepts_only_strict_improvements():
    """Under congestion every accepted plan strictly beats its
    incumbent's key, kept plans report the incumbent's key (or inf), and
    the final plans replay to the last round's cost."""
    env, dags = _fleet(port)
    cfg = port.ReplanConfig(pso=CFG, migration_weight=0.1)
    trace = port.sample_trace("congestion", env, rounds=3, seed=5,
                              severity=0.8)
    report = port.replan_fleet(dags, trace, cfg, seed=0, device=CPU)
    assert len(report.rounds) == 2
    for log in report.rounds:
        acc = log.replanned & ~log.demoted
        assert (log.candidate_key[acc] < log.incumbent_key[acc]).all()
        kept = ~log.replanned & log.feasible
        np.testing.assert_allclose(log.cost[kept], log.incumbent_key[kept])
        assert np.isinf(log.cost[~log.replanned & ~log.feasible]).all()
    last = report.rounds[-1]
    env_last = trace.env_at(trace.num_rounds - 1)
    for i, d in enumerate(dags):
        r = port.simulate_np(port.SimProblem.build(d, env_last),
                             report.plans[i], faithful=CFG.faithful_sim)
        assert bool(r.feasible) == last.feasible[i]
        if last.feasible[i]:
            np.testing.assert_allclose(last.cost[i], r.total_cost, rtol=RTOL)


def test_load_surge_replan_under_traffic():
    """A load-surge trace leaves the environment still, yet every round
    is scored under the surged request stream (traffic keys on both
    sides of the comparison)."""
    env, dags = _fleet(port, nets=("alexnet", "googlenet"))
    trace = port.sample_trace("load-surge", env, rounds=3, seed=0,
                              severity=1.0)
    cfg = port.ReplanConfig(
        pso=CFG, migration_weight=0.1,
        traffic=port.TrafficConfig(kind="bursty", rate=0.3, horizon=20.0,
                                   max_requests=4, mc_solver=2, mc_eval=4))
    report = port.replan_fleet(dags, trace, cfg, seed=0, device=CPU)
    assert len(report.rounds) == 2
    for log in report.rounds:
        acc = log.replanned & ~log.demoted
        assert (log.candidate_key[acc] < log.incumbent_key[acc]).all()
        assert np.isfinite(log.cost[log.feasible]).all()
    # the last round's kept plans carry their traffic key under the
    # round's surged draws
    last = report.rounds[-1]
    arr = port.online._round_arrivals(cfg, dags, trace.events[2], 2000)
    keys = port.incumbent_keys([port.SimProblem.build(d, env) for d in dags],
                               report.plans, CFG, arrivals=arr, device=CPU)
    kept = ~last.replanned
    np.testing.assert_array_equal(keys[kept], last.incumbent_key[kept])
