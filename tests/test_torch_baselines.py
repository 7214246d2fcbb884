"""The paper's comparators in the port against the reference: the GA (with
and without a request stream), PSO with the linear inertia of Eq. 21 and
prePSO, each fed the reference's own random draws; plus the reference's
properties of these functions (``tests/test_pso_ga.py``) on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity import CPU, RTOL, RefDraws, legacy_stream, port_cfg

import repro.core as ref
import repro_torch.core as port

torch.set_num_threads(1)

FAST = dict(pop_size=16, max_iters=30, stall_iters=10)


def _deadlined(lib, net, ratio, n_devices=1):
    env = lib.paper_environment()
    dag = lib.merge_dags([lib.zoo.build(net, pin_server=d)
                          for d in range(n_devices)])
    h, _ = lib.heft_makespan(dag, env)
    return dag.with_deadline(np.full(dag.num_apps, ratio * h)), env


def ga_cfg(cfg_ref) -> port.GAConfig:
    """The port's GA config with the reference config's shared fields."""
    return port.GAConfig(**{f.name: getattr(cfg_ref, f.name)
                            for f in dataclasses.fields(port.GAConfig)})


class RefGADraws:
    """The reference GA's stream (``baselines.py:154-170``):
    ``key, k0 = split(PRNGKey(seed))`` and the initial population from
    ``k0``, then per generation ``split(key, 6)`` and the same
    ``randint`` / ``uniform`` calls. Usable as ``run_ga``'s ``draw_fn``."""

    def __init__(self, prob, cfg_ref, seed: int):
        self.P, self.T = cfg_ref.pop_size, cfg_ref.tournament
        self.p, self.s = prob.num_layers, prob.num_servers
        with legacy_stream():
            key, k0 = jax.random.split(jax.random.PRNGKey(seed))
            self.X0 = np.asarray(jax.random.randint(
                k0, (self.P, self.p), 0, self.s, dtype=jnp.int32))
        self.key = key

    def __call__(self, gen: int) -> port.GADraws:
        P, p = self.P, self.p
        with legacy_stream():
            self.key, kt, kxp, kseg, kmu, kmuv = jax.random.split(self.key, 6)
            d = port.GADraws(
                cand=jax.random.randint(kt, (P, 2, self.T), 0, P),
                do_x=jax.random.uniform(kxp, (P,)),
                seg=jax.random.randint(kseg, (P, 2), 0, p),
                mu=jax.random.uniform(kmu, (P, p)),
                vals=jax.random.randint(kmuv, (P, p), 0, self.s,
                                        dtype=jnp.int32))
        return port.GADraws(*(np.asarray(v) for v in d))


def _assert_same(got, want, rtol=RTOL):
    np.testing.assert_array_equal(got.best_x, np.asarray(want.best_x))
    assert (got.iterations, got.feasible) == (want.iterations,
                                              want.feasible)
    np.testing.assert_allclose(got.best_fitness, want.best_fitness,
                               rtol=rtol)
    np.testing.assert_allclose(got.best_cost, want.best_cost, rtol=rtol)


@pytest.mark.parametrize("net,faithful,ratio", [
    ("alexnet", False, 2.0), ("alexnet", True, 2.0),
    ("googlenet", False, 3.0), ("googlenet", True, 1.5)])
def test_run_ga_fed_reference_draws(net, faithful, ratio):
    """``run_ga`` fed the reference's initial population and per-generation
    draws: the same winner, iterations and feasibility, keys to rtol."""
    cfg_ref = ref.GAConfig(faithful_sim=faithful, **FAST)
    rdag, renv = _deadlined(ref, net, ratio)
    dag, env = _deadlined(port, net, ratio)
    with legacy_stream():
        want = ref.run_ga(rdag, renv, cfg_ref, seed=3)
    draws = RefGADraws(ref.SimProblem.build(rdag, renv), cfg_ref, 3)
    got = port.run_ga(dag, env, ga_cfg(cfg_ref), device=CPU, X0=draws.X0,
                      draw_fn=draws)
    _assert_same(got, want)
    assert got.iterations >= 1


@pytest.mark.parametrize("faithful,ratio,rate", [(False, 3.0, 0.1),
                                                (True, 1.5, 0.5)])
def test_run_ga_under_traffic_fed_reference_draws(faithful, ratio, rate):
    """The GA under the traffic key (two apps, bursty draws; a winner
    inside the miss budget, and one over it): the same winner and
    iterations; the traffic key to rtol."""
    cfg_ref = ref.GAConfig(faithful_sim=faithful, **FAST)
    tc = port.TrafficConfig(kind="bursty", rate=rate)
    arr = tc.solver_arrivals(2, seed=5)
    rdag, renv = _deadlined(ref, "alexnet", ratio, n_devices=2)
    dag, env = _deadlined(port, "alexnet", ratio, n_devices=2)
    with legacy_stream():
        want = ref.run_ga(rdag, renv, cfg_ref, seed=1, arrivals=arr)
    draws = RefGADraws(ref.SimProblem.build(rdag, renv), cfg_ref, 1)
    got = port.run_ga(dag, env, ga_cfg(cfg_ref), device=CPU, X0=draws.X0,
                      draw_fn=draws, arrivals=arr)
    _assert_same(got, want)
    # the key the GA minimised is the traffic key of its winner
    pp = port.pad_problem(port.SimProblem.build(dag, env), device=CPU)
    key = port.make_swarm_fitness(pp, faithful, arrivals=arr)(
        torch.as_tensor(got.best_x[None]))[0]
    assert float(key) == got.best_fitness


@pytest.mark.parametrize("faithful", [False, True])
def test_run_pso_linear_fed_reference_draws(faithful):
    """``run_pso_linear`` fed ``RefDraws``: gene for gene."""
    cfg_ref = ref.PSOGAConfig(faithful_sim=faithful, **FAST)
    rdag, renv = _deadlined(ref, "googlenet", 2.0)
    dag, env = _deadlined(port, "googlenet", 2.0)
    with legacy_stream():
        want = ref.run_pso_linear(rdag, renv, cfg_ref, seed=2)
    draws = RefDraws([ref.SimProblem.build(rdag, renv)], cfg_ref, [2])
    got = port.run_pso_linear(dag, env, port_cfg(cfg_ref), device=CPU,
                              X0=draws.X0[0], draw_fn=draws)
    _assert_same(got, want)


def test_pre_pso_fed_reference_draws():
    """``pre_pso`` fed ``RefDraws`` on the compressed DAG: the same
    expanded plan and cost."""
    cfg_ref = ref.PSOGAConfig(**FAST)
    rdag, renv = _deadlined(ref, "googlenet", 5.0)
    dag, env = _deadlined(port, "googlenet", 5.0)
    with legacy_stream():
        want = ref.pre_pso(rdag, renv, cfg_ref, seed=0)
    small, _ = ref.preprocess(rdag)
    draws = RefDraws([ref.SimProblem.build(small, renv)], cfg_ref, [0])
    got = port.pre_pso(dag, env, port_cfg(cfg_ref), device=CPU,
                       X0=draws.X0[0], draw_fn=draws)
    _assert_same(got, want)
    assert got.best_x.shape == (dag.num_layers,)


def test_psoga_no_worse_than_ga_googlenet():
    """Paper Fig. 7(c): PSO-GA ≤ GA on a branching DAG, within the
    reference test's 5 % stochastic margin."""
    dag, env = _deadlined(port, "googlenet", 3.0)
    pso = port.run_pso_ga(dag, env, port.PSOGAConfig(**FAST), seed=0,
                          device=CPU)
    ga = port.run_ga(dag, env, port.GAConfig(**FAST), seed=0, device=CPU)
    assert pso.feasible
    if ga.feasible:
        assert pso.best_cost <= ga.best_cost * 1.05


def test_pre_pso_expansion_valid():
    """The prePSO plan has the original DAG's length, keeps its pins, and
    its cost is its ``simulate_np`` replay."""
    dag, env = _deadlined(port, "googlenet", 5.0)
    res = port.pre_pso(dag, env, port.PSOGAConfig(**FAST), seed=0,
                       device=CPU)
    assert res.best_x.shape == (dag.num_layers,)
    pinned = dag.pinned >= 0
    assert (res.best_x[pinned] == dag.pinned[pinned]).all()
    r = port.simulate_np(port.SimProblem.build(dag, env), res.best_x,
                         faithful=False)
    assert res.feasible == bool(r.feasible)
    if res.feasible:
        np.testing.assert_allclose(res.best_cost, float(r.total_cost),
                                   rtol=1e-6)


def test_pso_linear_runs_on_fig2():
    env = port.sample_environment()
    dag = port.LayerDAG(
        compute=np.array([1.1, 1.92, 2.35, 2.12]) * env.power[0],
        edges=np.array([[0, 1], [0, 2], [1, 3], [2, 3]]),
        edge_mb=np.array([1.0, 1.0, 0.5, 0.5]),
        app_id=np.zeros(4, np.int32), deadline=np.array([3.7]),
        pinned=np.array([0, -1, -1, -1], np.int32))
    res = port.run_pso_linear(dag, env, port.PSOGAConfig(**FAST), seed=0,
                              device=CPU)
    assert res.best_x.shape == (4,) and res.best_x[0] == 0
    assert res.iterations >= 1


@pytest.mark.parametrize("solver", ["ga", "pso_linear"])
def test_pins_respected(solver):
    dag, env = _deadlined(port, "alexnet", 2.0, n_devices=3)
    fn = port.run_ga if solver == "ga" else port.run_pso_linear
    cfg = port.GAConfig(**FAST) if solver == "ga" \
        else port.PSOGAConfig(**FAST)
    res = fn(dag, env, cfg, seed=4, device=CPU)
    pinned = dag.pinned >= 0
    assert (res.best_x[pinned] == dag.pinned[pinned]).all()
    assert res.best_x.dtype == np.int32


def test_ga_best_key_never_rises():
    """Elitism: the best key after k generations never exceeds the best
    after k − 1, for the same seed (the same draws up to k)."""
    dag, env = _deadlined(port, "alexnet", 1.5, n_devices=2)
    best = []
    for k in range(1, 11):
        cfg = port.GAConfig(pop_size=8, max_iters=k, stall_iters=100)
        res = port.run_ga(dag, env, cfg, seed=7, device=CPU)
        assert res.iterations == k
        best.append(res.best_fitness)
    assert (np.diff(best) <= 0).all(), best
    assert best[-1] < best[0]
