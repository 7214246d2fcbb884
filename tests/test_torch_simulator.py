"""Port vs reference for the Algorithm-2 simulator: the swarm replay and
the one-assignment replay on the four zoo DNNs in both fidelity modes,
padded and unpadded, plus the paper's Fig. 2 worked example."""
import jax
import numpy as np
import pytest
import torch
from test_torch_parity import CPU, RTOL, link_aware_swarm, np_of, to_port

import repro.core as ref
import repro_torch.core as port
from repro.core.dag import LayerDAG as RefLayerDAG

torch.set_num_threads(1)


def _zoo_problem(net, n_devices=1):
    """``net`` on ``n_devices`` end devices of the paper fleet, deadline
    2×HEFT: a mix of feasible and infeasible random particles."""
    env = ref.paper_environment()
    dag = ref.merge_dags([ref.zoo.build(net, pin_server=d)
                          for d in range(n_devices)])
    h, _ = ref.heft_makespan(dag, env)
    dag = dag.with_deadline(np.full(dag.num_apps, 2.0 * h))
    return ref.SimProblem.build(dag, env)


_ref_swarm = jax.jit(ref.simulate_swarm, static_argnums=2)
_ref_padded = jax.jit(ref.simulate_padded, static_argnums=2)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("net", ref.zoo.NAMES)
def test_simulate_swarm_matches_reference(net, faithful):
    """Per-particle (total, feasible, Σ completion) agree with the
    reference's swarm scan, and the port's result is identical whether
    the problem is padded or not."""
    prob = _zoo_problem(net, n_devices=2)
    rng = np.random.default_rng(7)
    X = link_aware_swarm(rng, prob, 12, prob.num_layers)
    want = [np.asarray(o) for o in _ref_swarm(ref.pad_problem(prob), X,
                                              faithful)]
    got = [np_of(o) for o in port.simulate_swarm(
        port.pad_problem(prob, device=CPU), torch.as_tensor(X), faithful)]
    assert got[1].any() and not got[1].all()       # both kinds present
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)

    max_p = prob.num_layers + 13
    Xp = np.zeros((12, max_p), np.int32)
    Xp[:, :prob.num_layers] = X
    padded = port.simulate_swarm(
        port.pad_problem(prob, max_p=max_p, max_S=32, max_in=5, max_out=6,
                         max_apps=5, device=CPU),
        torch.as_tensor(Xp), faithful)
    for a, b in zip(padded, got):
        np.testing.assert_array_equal(np_of(a), b)   # bit-identical


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("net", ["alexnet", "googlenet"])
def test_simulate_padded_matches_reference(net, faithful):
    prob = _zoo_problem(net)
    pp_ref = ref.pad_problem(prob, max_p=prob.num_layers + 3, max_apps=2)
    pp = to_port(pp_ref)
    rng = np.random.default_rng(1)
    X = link_aware_swarm(rng, prob, 3, pp.max_layers)
    for x in X:
        want = _ref_padded(pp_ref, x, faithful)
        got = port.simulate_padded(pp, torch.as_tensor(x), faithful)
        assert bool(got.feasible) == bool(want.feasible)
        for field in ("end_times", "app_completion", "comp_cost",
                      "trans_cost", "total_cost", "makespan"):
            np.testing.assert_allclose(np_of(getattr(got, field)),
                                       np.asarray(getattr(want, field)),
                                       rtol=RTOL, err_msg=field)
        oracle = port.simulate_np(prob, x[:prob.num_layers], faithful)
        np.testing.assert_allclose(np_of(got.end_times)[:prob.num_layers],
                                   oracle.end_times, rtol=RTOL)


def _fig2(lib):
    env = lib.sample_environment()
    LayerDAG = RefLayerDAG if lib is ref else port.LayerDAG
    dag = LayerDAG(
        compute=np.array([1.1, 1.92, 2.35, 2.12]) * env.power[0],
        edges=np.array([[0, 1], [0, 2], [1, 3], [2, 3]]),
        edge_mb=np.array([1.0, 1.0, 0.5, 0.5]),
        app_id=np.zeros(4, np.int32), deadline=np.array([3.7]),
        pinned=np.array([0, -1, -1, -1], np.int32))
    return dag, env


@pytest.mark.parametrize("x, lo, hi, feasible", [
    ((0, 1, 2, 1), 3.4, 3.8, True),      # greedy, ~3.65 s (Fig. 2(b))
    ((0, 1, 2, 3), 3.1, 3.6, True),      # optimal, ~3.41 s (Fig. 2(c))
    ((0, 0, 2, 3), 3.7, 99.0, False),    # "more than 4 s" (Property 3)
])
def test_fig2_worked_example(x, lo, hi, feasible):
    """The paper's Fig. 2 numbers through the port's tensor replay,
    matching the reference's numpy oracle."""
    dag, env = _fig2(port)
    prob = port.SimProblem.build(dag, env)
    res = port.build_simulator(prob, faithful=False, device=CPU)(
        torch.tensor(x))
    assert lo <= float(res.makespan) <= hi
    assert bool(res.feasible) == feasible
    rdag, renv = _fig2(ref)
    want = ref.simulate_np(ref.SimProblem.build(rdag, renv), np.array(x),
                           faithful=False)
    np.testing.assert_allclose(float(res.makespan), float(want.makespan),
                               rtol=RTOL)
    np.testing.assert_allclose(float(res.total_cost),
                               float(want.total_cost), rtol=RTOL)


def test_faithful_mode_drops_parent_gating():
    dag, env = _fig2(port)
    sim = lambda f: port.build_simulator(port.SimProblem.build(dag, env),
                                         faithful=f, device=CPU)
    x = torch.tensor([0, 1, 2, 3])
    assert float(sim(True)(x).makespan) < float(sim(False)(x).makespan)
