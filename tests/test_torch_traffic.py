"""Contention-aware planning in the port against the reference: arrival
traces, the traffic fitness key and its p95, traffic solves reproducing
the queue-aware goldens of ``tests/golden_costs.json``, the batched
traffic solver, ``pack_arrivals`` and ``plan_offload_batch(traffic=)``.

Tolerances: integers, booleans, arrival times and miss rates exact;
float32 costs and keys rtol 1e-5 (the packages sum in different orders).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity import (CPU, RTOL, RefDraws, legacy_stream,
                               link_aware_swarm, np_of, port_cfg,
                               ref_step_draws, to_port)

import repro.configs as ref_configs
import repro.core as ref
import repro_torch.configs as port_configs
import repro_torch.core as port
from repro.core.batch import pack_arrivals as ref_pack_arrivals
from repro.core.pso_ga import _SwarmState as RefState
from repro.core.pso_ga import swarm_step as ref_swarm_step

torch.set_num_threads(1)

GOLDENS = json.loads(
    (Path(__file__).parent / "golden_costs.json").read_text())
_TCFG = GOLDENS["_traffic_config"]


def _deadlined(lib, net, ratio, pin=0):
    env = lib.paper_environment()
    dag = lib.zoo.build(net, pin_server=pin)
    h, _ = lib.heft_makespan(dag, env)
    return dag.with_deadline(np.array([ratio * h])), env


# ---------------------------------------------------------------------------
# arrival traces (numpy, copied): the same draws from the same seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ref.TRAFFIC_KINDS)
def test_sample_arrivals_bit_equal_to_reference(kind):
    for seed in (0, 7, np.int64(3), np.array(11), -5):
        a = ref.sample_arrivals(kind, 3, rate=0.6, horizon=20.0,
                                max_requests=6, n_seeds=3, seed=seed)
        b = port.sample_arrivals(kind, 3, rate=0.6, horizon=20.0,
                                 max_requests=6, n_seeds=3, seed=seed)
        np.testing.assert_array_equal(a.t, b.t)
        assert (a.kind, a.rate, a.horizon) == (b.kind, b.rate, b.horizon)
        np.testing.assert_array_equal(a.counts(), b.counts())


def test_traffic_config_draws_and_validation():
    tc_r = ref.TrafficConfig(kind="flash-crowd", rate=0.4, mc_eval=4)
    tc_p = port.TrafficConfig(kind="flash-crowd", rate=0.4, mc_eval=4)
    for seed in (0, 31):
        np.testing.assert_array_equal(tc_r.solver_arrivals(2, seed=seed),
                                      tc_p.solver_arrivals(2, seed=seed))
        np.testing.assert_array_equal(
            tc_r.eval_arrivals(2, seed=seed, rate_scale=2.0),
            tc_p.eval_arrivals(2, seed=seed, rate_scale=2.0))
    assert not np.array_equal(tc_p.solver_arrivals(2), tc_p.eval_arrivals(2))
    for bad in (dict(kind="tsunami"), dict(rate=0.0), dict(rate=np.nan),
                dict(horizon=-1.0), dict(max_requests=0), dict(mc_solver=0),
                dict(mc_eval=0), dict(miss_budget=1.5),
                dict(miss_budget=np.nan)):
        with pytest.raises(ValueError):
            port.TrafficConfig(**bad)
    with pytest.raises(ValueError):
        port.sample_arrivals("poisson", 0)
    assert port.zero_contention_arrivals(3, n_seeds=2).shape == (2, 3, 1)


# ---------------------------------------------------------------------------
# the traffic fitness key
# ---------------------------------------------------------------------------

_JIT_P95 = jax.jit(lambda x: jnp.percentile(x, 95.0, axis=0))


@pytest.mark.parametrize("M", range(1, 65))
def test_p95_equals_jnp_percentile_bit_for_bit(M):
    """The port's p95 against the reference's as its solver runs it,
    inside ``jit`` (an eager ``jnp.percentile`` rounds the position
    differently for some M, e.g. 6, 10, 16, 32 and 48)."""
    rng = np.random.default_rng(M)
    n_req = rng.integers(1, 40, size=(1, 4096))
    x = ((rng.integers(0, 41, size=(M, 4096)) % (n_req + 1))
         / n_req).astype(np.float32)
    want = np.asarray(_JIT_P95(jnp.asarray(x)))
    got = np_of(port.percentile_linear(torch.tensor(x), 95.0, dim=0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("faithful", [True, False])
def test_fitness_traffic_branch_matches_reference(faithful):
    """A stacked bucket of two problems, M = 3 draws, scored in one call,
    against the reference key per problem: both branches of the key, a
    zero and a loose miss budget, and the migration term."""
    rng = np.random.default_rng(3)
    probs, pps, arrs = [], [], []
    for i, (net, ratio) in enumerate((("alexnet", 1.5), ("vgg19", 3.0))):
        dag, env = _deadlined(ref, net, ratio, pin=i)
        probs.append(ref.SimProblem.build(dag, env))
        pps.append(ref.pad_problem(probs[-1], max_p=32, max_S=32))
        arrs.append(ref.sample_arrivals("bursty", 1, rate=0.5, horizon=20.0,
                                        max_requests=5, n_seeds=3,
                                        seed=i).t)
    stacked = port.stack_problems([to_port(pp) for pp in pps])
    X = np.stack([link_aware_swarm(rng, pr, 12, 32) for pr in probs])
    inc = np.stack([X[n, 3] for n in range(2)])
    for budget, incumbent in ((0.0, None), (0.5, inc)):
        got = np_of(port.make_swarm_fitness(
            stacked, faithful, arrivals=port.pack_arrivals(arrs, 1),
            miss_budget=budget,
            incumbent=None if incumbent is None else torch.tensor(incumbent),
            mig_weight=0.5)(torch.tensor(X)))
        for n, pp in enumerate(pps):
            want = np.asarray(ref.make_swarm_fitness(
                pp, faithful, arrivals=jnp.asarray(arrs[n]),
                miss_budget=budget,
                incumbent=None if incumbent is None
                else jnp.asarray(incumbent[n]), mig_weight=0.5)(X[n]))
            np.testing.assert_array_equal(
                got[n] >= port.INFEASIBLE_OFFSET,
                want >= ref.fitness.INFEASIBLE_OFFSET)
            np.testing.assert_allclose(got[n], want, rtol=RTOL)
    assert (got < port.INFEASIBLE_OFFSET).any() \
        and (got >= port.INFEASIBLE_OFFSET).any()


def test_zero_contention_traffic_key_equals_base_key():
    """One request per app at t = 0 under a zero budget: every feasible
    particle keeps its zero-load cost, bit for bit."""
    rng = np.random.default_rng(0)
    dag, env = _deadlined(port, "alexnet", 3.0)
    prob = port.SimProblem.build(dag, env)
    pp = port.pad_problem(prob, device=CPU)
    X = torch.tensor(link_aware_swarm(rng, prob, 8, prob.num_layers))
    base = port.make_swarm_fitness(pp, faithful=False)(X)
    traf = port.make_swarm_fitness(
        pp, faithful=False, arrivals=port.zero_contention_arrivals(1, 2),
        miss_budget=0.0)(X)
    feas = base < port.INFEASIBLE_OFFSET
    assert feas.any()
    assert torch.equal(traf[feas], base[feas])
    assert (traf[~feas] >= port.INFEASIBLE_OFFSET).all()


# ---------------------------------------------------------------------------
# solves: goldens with the reference's draws, batched == sequential
# ---------------------------------------------------------------------------

_GOLDEN_CASES = [(net, kind, _TCFG["deadline_ratio"], _TCFG["miss_budget"],
                  f"{net}|traffic={kind}")
                 for net in ("alexnet", "googlenet")
                 for kind in ("bursty", "flash-crowd")]
_GOLDEN_CASES.append(("alexnet", "flash-crowd", 0.5, 0.0,
                      "alexnet|traffic=flash-crowd|pallas|infeasible"))


@pytest.mark.parametrize("net,kind,ratio,budget,key", _GOLDEN_CASES,
                         ids=[c[-1] for c in _GOLDEN_CASES])
def test_traffic_goldens_with_reference_draws(net, kind, ratio, budget, key):
    """``run_pso_ga(arrivals=)`` fed the reference's initial swarm and step
    draws reproduces the queue-aware goldens, iteration counts included;
    ``feasible``/``best_cost`` are the zero-load replay's, so the
    googlenet flash-crowd plan is feasible with a key above the offset."""
    want = GOLDENS[key]
    dag, env = _deadlined(port, net, ratio)
    rdag, renv = _deadlined(ref, net, ratio)
    arr = port.sample_arrivals(kind, 1, seed=_TCFG["seed"],
                               **_TCFG["arrivals"]).t
    cfg_ref = ref.PSOGAConfig(pop_size=_TCFG["pop_size"],
                              max_iters=_TCFG["max_iters"],
                              stall_iters=_TCFG["stall_iters"],
                              miss_budget=budget)
    draws = RefDraws([ref.SimProblem.build(rdag, renv)], cfg_ref,
                     [_TCFG["seed"]])
    res = port.run_pso_ga(dag, env, port_cfg(cfg_ref), device=CPU,
                          X0=draws.X0[0], draw_fn=draws, arrivals=arr)
    assert res.feasible == want["feasible"]
    assert res.iterations == want["iterations"]
    np.testing.assert_allclose(res.best_fitness, want["best_fitness"],
                               rtol=RTOL)
    np.testing.assert_allclose(res.best_cost, want["best_cost"], rtol=RTOL)


def test_batched_traffic_equals_sequential_gene_for_gene():
    """Three problems in two buckets, each with its own draws: every
    batched result equals its own sequential traffic solve exactly."""
    cfg = port.PSOGAConfig(pop_size=10, max_iters=24, stall_iters=6,
                           miss_budget=0.2)
    fleet = [_deadlined(port, "alexnet", 1.5, pin=0),
             _deadlined(port, "googlenet", 2.0, pin=1),
             _deadlined(port, "alexnet", 1.2, pin=2)]
    arrs = [port.sample_arrivals(kind, 1, rate=0.5, horizon=20.0,
                                 max_requests=5, n_seeds=2, seed=i).t
            for i, kind in enumerate(("bursty", "flash-crowd", "poisson"))]
    seeds = [4, 9, 1]
    batched = port.run_pso_ga_batch(fleet, cfg, seed=seeds, device=CPU,
                                    arrivals=arrs)
    for (dag, env), seed, arr, got in zip(fleet, seeds, arrs, batched):
        want = port.run_pso_ga(dag, env, cfg, seed=seed, device=CPU,
                               arrivals=arr)
        np.testing.assert_array_equal(got.best_x, want.best_x)
        assert got.best_fitness == want.best_fitness
        assert (got.best_cost, got.feasible, got.iterations) == \
            (want.best_cost, want.feasible, want.iterations)


def test_pack_arrivals_matches_reference_and_validates():
    ok = [np.zeros((2, 1, 4)), np.full((2, 2, 4), 3.0)]
    np.testing.assert_array_equal(port.pack_arrivals(ok, 3),
                                  ref_pack_arrivals(ok, 3))
    assert np.isinf(port.pack_arrivals(ok, 3)[0, :, 1:]).all()
    for bad, max_apps in (([np.zeros((2, 1, 4)), np.zeros((3, 1, 4))], 3),
                          ([np.zeros((2, 1, 4)), np.zeros((2, 1, 5))], 3),
                          ([np.zeros((2, 7, 4))], 3),
                          ([np.zeros((1, 4))], 3),
                          ([np.full((2, 1, 4), np.nan)], 3),
                          ([np.full((2, 1, 4), -1.0)], 3), ([], 3)):
        with pytest.raises(ValueError):
            port.pack_arrivals(bad, max_apps)
    dag, env = _deadlined(port, "alexnet", 2.0)
    with pytest.raises(ValueError):
        port.run_pso_ga_batch([(dag, env)], port.PSOGAConfig(pop_size=4),
                              device=CPU, arrivals=[np.zeros((2, 1, 4))] * 2)


# ---------------------------------------------------------------------------
# the planner front end
# ---------------------------------------------------------------------------

def test_plan_offload_batch_traffic_report_equals_reference_stats():
    """The held-out report of each traffic plan equals the reference's
    ``traffic_stats`` of the same plan on the same evaluation draws."""
    tc = port.TrafficConfig(kind="bursty", rate=0.5, mc_solver=2, mc_eval=4,
                            miss_budget=0.1)
    shapes = [s for s in port_configs.SHAPES if s.kind != "train"][:2]
    plans = port.plan_offload_batch(
        [(port_configs.get("qwen3-0.6b"), s, 1.5) for s in shapes],
        pso=port.PSOGAConfig(pop_size=8, max_iters=5, stall_iters=40),
        seed=3, device=CPU, traffic=tc)
    tc_ref = ref.TrafficConfig(kind="bursty", rate=0.5, mc_solver=2,
                               mc_eval=4, miss_budget=0.1)
    env = ref.tpu_fleet_environment()
    for i, plan in enumerate(plans):
        dag = ref.arch_to_dag(ref_configs.get("qwen3-0.6b"),
                              ref_configs.SHAPES[port_configs.SHAPES.index(
                                  shapes[i])], pin_server=6)
        np.testing.assert_array_equal(dag.compute, plan.dag.compute)
        dag = dag.with_deadline(np.asarray([plan.deadline]))
        want = ref.traffic_stats(ref.traffic_replay(
            ref.SimProblem.build(dag, env), plan.result.best_x,
            tc_ref.eval_arrivals(1, seed=3 + 31 * i), faithful=False))
        got = plan.traffic
        assert set(got) == set(want)
        for k in ("miss_mean", "miss_p50", "miss_p95", "miss_p99",
                  "requests", "feasible"):
            assert got[k] == want[k], k
        for k in ("cost_mean", "latency_p95"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
        assert "traffic: miss p50/p95/p99" in plan.summary()
        assert plan.backend == "cpu"


@pytest.mark.parametrize("n_seeds", [2, 16])
def test_swarm_step_under_traffic_fed_reference_draws(n_seeds):
    """``swarm_step(arrivals=)`` fed the reference's draws gives the
    reference traffic step's swarm, pBests and gBest, gene for gene. At
    16 draws the p95's interpolation point is one that an eager
    ``jnp.percentile`` rounds differently from the jitted step."""
    dag, env = _deadlined(ref, "alexnet", 1.5)
    prob = ref.SimProblem.build(dag, env)
    cfg_ref = ref.PSOGAConfig(pop_size=8, max_iters=20, miss_budget=0.2)
    pp_ref = ref.pad_problem(prob, max_p=16)
    arr = ref.sample_arrivals("flash-crowd", 1, rate=0.5, horizon=20.0,
                              max_requests=3, n_seeds=n_seeds, seed=1).t
    rng = np.random.default_rng(0)
    X0 = link_aware_swarm(rng, prob, 8, 16)
    pp = to_port(pp_ref)
    f0 = np_of(port.make_swarm_fitness(pp, False, arrivals=arr,
                                       miss_budget=0.2)(torch.tensor(X0)))
    i0 = int(np.argmin(f0))
    with legacy_stream():
        st_ref = RefState(key=jax.random.PRNGKey(3), X=X0, pbest_x=X0,
                          pbest_f=f0, gbest_x=X0[i0], gbest_f=f0[i0],
                          it=np.int32(0), stall=np.int32(0))
    st = port.state_from_arrays(st_ref, device=CPU)
    step_ref = jax.jit(lambda pp_, s: ref_swarm_step(
        pp_, s, cfg_ref, arrivals=jnp.asarray(arr)))
    for _ in range(3):
        with legacy_stream():
            _, draws = ref_step_draws(st_ref.key, 8, prob.num_layers,
                                      prob.num_servers)
            st_ref = step_ref(pp_ref, st_ref)
        st = port.swarm_step(pp, st, port_cfg(cfg_ref), draws=port.SwarmDraws(
            *(torch.tensor(d) for d in draws)), arrivals=arr)
        for field in ("X", "pbest_x", "gbest_x", "it", "stall"):
            np.testing.assert_array_equal(np_of(getattr(st, field)),
                                          np.asarray(getattr(st_ref, field)),
                                          err_msg=field)
        np.testing.assert_allclose(np_of(st.pbest_f),
                                   np.asarray(st_ref.pbest_f), rtol=RTOL)
